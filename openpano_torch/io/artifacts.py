"""Stage artifact store: features, match graph, cameras; resumable stages.

Counterpart of ``openpano_tpu/io/artifacts.py``, with the same npz keys and
the same text format, so a file one package writes loads in the other.  The
reference's only checkpoint is the debug match-graph text dump
(dump_matchinfo/load_matchinfo, stitch/debug.cc:111-140, format of
MatchInfo::serialize at match_info.hh:26-50), which lets a developer re-run
bundle adjustment and the blend without matching again.  Here each stage
saves and loads its output: features (npz), the pairwise match graph (npz,
and the reference-compatible text) and the estimated cameras (npz).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_features(path: str, feats) -> None:
    np.savez_compressed(path, pos=_host(feats.pos), desc=_host(feats.desc),
                        valid=_host(feats.valid))


def load_features(path: str, device=None):
    """The saved Features as tensors on ``device`` (the CPU when None)."""
    from ..sift.descriptor import Features

    z = np.load(path)
    dev = torch.device("cpu" if device is None else device)
    return Features(*(torch.from_numpy(z[k]).to(dev)
                      for k in ("pos", "desc", "valid")))


def save_match_graph(path: str, graph) -> None:
    np.savez_compressed(
        path,
        conf=graph.conf, homo=graph.homo,
        to_pos=graph.to_pos, from_pos=graph.from_pos, valid=graph.valid,
    )


def load_match_graph(path: str):
    from ..stitch.stitcher import PairwiseGraph

    z = np.load(path)
    n, M = z["conf"].shape[0], z["to_pos"].shape[2]
    g = PairwiseGraph(n, M)
    g.conf = z["conf"]
    g.homo = z["homo"]
    g.to_pos = z["to_pos"]
    g.from_pos = z["from_pos"]
    g.valid = z["valid"]
    return g


def save_cameras(path: str, cams) -> None:
    np.savez_compressed(
        path, focal=cams.focal, ppx=cams.ppx, ppy=cams.ppy, R=cams.R
    )


def load_cameras(path: str):
    from ..camera.camera import CameraSet

    z = np.load(path)
    return CameraSet(focal=z["focal"], ppx=z["ppx"], ppy=z["ppy"], R=z["R"])


# ---- reference-compatible text format (match_info.hh:26-50) ----

def dump_matchinfo_text(path: str, graph) -> None:
    """Text dump in the reference's format: per (i, j) a line 'i j' and a
    line 'confidence h0..h8 nr_match x1 y1 x2 y2 ...' (debug.cc:111-125).
    Floats are written by ``repr``, which round-trips float64 exactly."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = graph.conf.shape[0]
    with open(path, "w") as f:
        for i in range(n):
            for j in range(n):
                if i == j or graph.conf[i, j] <= 0:
                    continue
                f.write(f"{i} {j}\n")
                parts = [repr(float(graph.conf[i, j]))]
                parts += [repr(float(v)) for v in graph.homo[i, j].reshape(9)]
                m = graph.valid[i, j]
                parts.append(str(int(m.sum())))
                for k in np.nonzero(m)[0]:
                    parts += [
                        repr(float(graph.to_pos[i, j, k, 0])),
                        repr(float(graph.to_pos[i, j, k, 1])),
                        repr(float(graph.from_pos[i, j, k, 0])),
                        repr(float(graph.from_pos[i, j, k, 1])),
                    ]
                f.write(" ".join(parts) + "\n")


def load_matchinfo_text(path: str, n: int, M: int):
    """The dumped graph as a PairwiseGraph of n images and M match slots;
    each pair's points fill a prefix of its slots, in the dumped order."""
    from ..stitch.stitcher import PairwiseGraph

    g = PairwiseGraph(n, M)
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for head, body in zip(lines[::2], lines[1::2]):
        i, j = map(int, head.split())
        vals = body.split()
        g.conf[i, j] = float(vals[0])
        g.homo[i, j] = np.array([float(v) for v in vals[1:10]]).reshape(3, 3)
        cnt = int(vals[10])
        pts = np.array([float(v) for v in vals[11 : 11 + cnt * 4]])
        pts = pts.reshape(cnt, 4)
        cnt = min(cnt, M)
        g.to_pos[i, j, :cnt] = pts[:cnt, 0:2]
        g.from_pos[i, j, :cnt] = pts[:cnt, 2:4]
        g.valid[i, j, :cnt] = True
    return g
