"""Seconds a panorama spends in the port's ``calc_feature`` stage timer, over
the clean panoramas."""


def read(run):
    return run.stage_per_pano("calc_feature")
