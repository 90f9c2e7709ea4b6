"""Megabytes the transport moved up the host link a panorama
(``io.wirecodec.STATS["up_bytes"]``), over the clean panoramas."""


def read(run):
    if not run.panos:
        return None
    return sum(p["up_bytes"] for p in run.panos) / len(run.panos) / 1e6
