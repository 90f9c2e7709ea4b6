"""Milliseconds an LM iteration of the bundle adjustment takes: the
estimator's ``lm_time_s`` over its ``lm_iters`` (``info_out``), summed
over the clean panoramas."""


def read(run):
    its = sum(p["lm_iters"] or 0 for p in run.panos)
    if not its:
        return None
    return 1000.0 * sum(p["lm_time_s"] or 0.0 for p in run.panos) / its
