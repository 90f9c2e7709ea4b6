"""K2's (the descriptor histogram's) share of its roofline in the traced
panorama: the least time its launches' inputs need on the H100
(``workmodel.k2_work``: needed plane pixels read once, the keypoints'
inputs, the histograms written) over the device time of the
``desc_hist_kernel`` kernels in the trace."""


def read(run):
    p = run.profile
    if not p or p.get("kernel_s", 0) <= 0 or not p.get("k2_least_s"):
        return None
    return 100.0 * p["k2_least_s"] / p["kernel_s"]
