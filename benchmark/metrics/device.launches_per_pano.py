"""Kernels launched on the card in the traced panorama (copies and
memsets not counted)."""


def read(run):
    p = run.profile
    if not p or not p.get("launches"):
        return None
    return float(p["launches"])
