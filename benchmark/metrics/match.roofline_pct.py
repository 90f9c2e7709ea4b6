"""The 2-NN match's share of its roofline in the traced panorama: the
least time the H100 needs for the cross terms these keypoints need
(2 Ki Kj 128 float32 operations a matched pair, each valid descriptor
read once) over the device's busy time inside the port's ``match_2nn``
stage, from the trace.  Float32's peak, since the configuration matches
in float32."""

from benchmark import judge, workmodel


def read(run):
    p = run.profile
    if not p or not len(p["kpt_counts"]):
        return None
    spent = p.get("stage_busy_s", {}).get("match_2nn", 0.0)
    if spent <= 0:
        return None
    ii, jj = judge.pair_list(p["n"], run.settings)
    return 100.0 * workmodel.least_seconds(
        *workmodel.match_work(p["kpt_counts"], ii, jj)) / spent
