"""The share of the traced panorama's wall in which no kernel, copy or
memset ran on the card: 1 - (union of device intervals) / wall."""


def read(run):
    p = run.profile
    if not p or p.get("window_s", 0) <= 0 or p.get("busy_s", 0) <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
