"""Seconds a panorama spends in the port's ``blend`` stage timer, over
the clean panoramas."""


def read(run):
    return run.stage_per_pano("blend")
