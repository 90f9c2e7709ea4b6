"""Seconds a panorama spends in the port's ``multiband.first_level`` stage
timer (the multiband blend's first-level planes and the winner-take-all
seam), over the clean panoramas; None where the port has no such timer."""


def read(run):
    return run.stage_per_pano("multiband.first_level")
