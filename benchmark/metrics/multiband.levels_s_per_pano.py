"""Seconds a panorama spends in the port's ``multiband.levels`` stage timer
(the multiband blend's band loop: each level's blur and accumulation, and
the clamp), over the clean panoramas; None where the port has no such
timer."""


def read(run):
    return run.stage_per_pano("multiband.levels")
