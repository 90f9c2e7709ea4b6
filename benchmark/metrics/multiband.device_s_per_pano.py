"""The card's busy seconds inside the port's ``blend`` stage (the join, the
plan, the render and the download) in the traced panorama, from the
trace; in a multiband cell the render is the multiband blend, and this,
read beside the two multiband timers, says whether the host's item loops
or the device's blurs set the blend's pace."""


def read(run):
    p = run.profile
    if not p or p.get("busy_s", 0) <= 0:
        return None
    spent = p.get("stage_busy_s", {}).get("blend", 0.0)
    return spent if spent > 0 else None
