"""Seconds a panorama spends in the port's ``estimate_camera`` stage timer, over
the clean panoramas."""


def read(run):
    return run.stage_per_pano("estimate_camera")
