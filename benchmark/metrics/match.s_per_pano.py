"""Seconds a panorama spends in the port's ``pairwise_match`` stage timer, over
the clean panoramas."""


def read(run):
    return run.stage_per_pano("pairwise_match")
