"""The benchmark of ``openpano_torch``, the PyTorch and CUDA port.

One run stitches panoramas back to back for ``--seconds`` and prints one
JSON line: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  The cells,
their configurations and metrics are named in ``BENCHMARK.json`` at the
root; each configuration (``configs/``), traffic mix (``traffic/``),
per-layer metric (``metrics/``), scene generator (``generators/``) and
cell's correctness limits (``limits/``) is a file of its own, found by its
name.  Nothing here imports JAX or the JAX package; ``reference.py`` and
the generators import nothing of the port either.
"""
