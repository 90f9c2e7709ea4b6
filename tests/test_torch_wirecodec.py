"""Port parity for the transport's codecs, on the CPU.

- ``native``: each C entry point of ``native/wire_codec.c`` and
  ``native/delta_code.c`` equals its plain numpy version (the JAX package's
  Python fallbacks) and the JAX package's loader;
- ``io.wirecodec``: ``_gap_code``, ``encode_plane`` (packed, gaps, vals),
  ``_decode4``, the 2-bit pack and unpack, and ``encode_plane_device``'s wire
  and exception buffers equal the JAX functions' on the same arrays, bit for
  bit; ``upload_u8_rows`` and ``CodedFetch`` round-trip, raw branches, row
  chunks and exceptions past the inline prefix included;
  ``BackgroundUpload`` at 4 and 2 bits, gated, released and abandoned;
- ``io.transfer``: ``fetch``, ``fetch_u8_delta`` and ``device_put_u8_delta``
  round-trip and agree with the JAX package's.

Every gate is equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu import native as jnative
from openpano_tpu.io import transfer as jtransfer
from openpano_tpu.io import wirecodec as jwc
from openpano_torch import native as tnative
from openpano_torch.io import transfer as ttransfer
from openpano_torch.io import wirecodec as twc

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth(rng, rows, cols, step=3):
    """A u8 plane whose row deltas mostly fit 4 bits (photo-like rows)."""
    x = np.cumsum(rng.integers(-step, step + 1, (rows, cols)), 1)
    return ((x + rng.integers(0, 256, (rows, 1))) % 256).astype(np.uint8)


def spiky(rng, rows, cols, frac):
    """A smooth plane with ``frac`` of its pixels replaced by noise."""
    p = smooth(rng, rows, cols)
    m = rng.uniform(size=p.shape) < frac
    p[m] = rng.integers(0, 256, int(m.sum()))
    return p


def tiny(rng, rows, cols):
    """Deltas in [-1, 1]: the chroma planes' statistics (2-bit codec)."""
    return smooth(rng, rows, cols, step=1)


# ---- native entry points ----

@pytest.mark.parametrize("bits,shape", [(4, (37, 50)), (4, (301, 300)),
                                        (2, (37, 50)), (2, (302, 301))])
def test_wire_pack_c_equals_plain_and_jax(bits, shape):
    rng = np.random.default_rng(bits * 1000 + shape[0])
    p = spiky(rng, *shape, 0.01) if bits == 4 else tiny(rng, *shape)
    c = (tnative.wire_pack4 if bits == 4 else tnative.wire_pack2)(p)
    plain = tnative.wire_pack_plain(p, bits)
    j = (jnative.wire_pack4 if bits == 4 else jnative.wire_pack2)(p)
    assert c is not None
    for a, b, d in zip(c, plain, j):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, d)


@pytest.mark.parametrize("bits", [4, 2])
def test_wire_pack_noisy_is_none(bits):
    p = np.random.default_rng(3).integers(0, 256, (64, 80)).astype(np.uint8)
    fn = tnative.wire_pack4 if bits == 4 else tnative.wire_pack2
    assert fn(p) is None
    assert tnative.wire_pack_plain(p, bits) is None
    assert twc.encode_plane(p, bits) is None


def test_grey_and_residual_c_equal_plain_and_jax():
    rgb = np.random.default_rng(4).integers(0, 256, (3, 17, 29, 3)).astype(
        np.uint8)
    g, r = tnative.wire_grey_res_u8(rgb)
    gp, rp = tnative.wire_grey_res_plain(rgb)
    gj, rj = jnative.wire_grey_res_u8(rgb)
    for a, b, c in ((g, gp, gj), (r, rp, rj)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(tnative.wire_grey_u8(rgb), g)
    s = rgb.astype(np.int32).sum(-1)
    np.testing.assert_array_equal(3 * g.astype(np.int32) + r - 1, s)
    assert set(np.unique(r)) <= {0, 1, 2}


@pytest.mark.parametrize("bits", [4, 2])
def test_wire_unpack_c_equals_plain(bits):
    rng = np.random.default_rng(5 + bits)
    rows, cols = 45, 61
    group = 2 if bits == 4 else 4
    packed = rng.integers(0, 256, ((rows + group - 1) // group, cols)).astype(
        np.uint8)
    idx = np.sort(rng.choice(rows * cols, 40, replace=False)).astype(np.int64)
    val = rng.integers(0, 256, 40).astype(np.uint8)
    c = tnative.wire_unpack(packed, rows, cols, idx, val, bits)
    np.testing.assert_array_equal(
        c, tnative.wire_unpack_plain(packed, rows, cols, idx, val, bits))
    np.testing.assert_array_equal(
        c, jnative.wire_unpack(packed, rows, cols, idx, val, bits))


def test_delta_rows_c_equal_plain_and_jax():
    x = np.random.default_rng(6).integers(0, 256, (33, 70)).astype(np.uint8)
    d = tnative.delta_encode_rows(x)
    np.testing.assert_array_equal(d, tnative.delta_encode_rows_plain(x))
    np.testing.assert_array_equal(d, jnative.delta_encode_rows(x))
    np.testing.assert_array_equal(tnative.delta_decode_rows(d), x)
    np.testing.assert_array_equal(tnative.delta_decode_rows_plain(d), x)


# ---- host encode, device decode ----

def test_gap_code_equals_jax_with_escapes():
    rng = np.random.default_rng(7)
    idx = np.sort(rng.choice(400000, 300, replace=False)).astype(np.int64)
    idx = np.concatenate([idx, [500000, 700000, 700001]])  # gaps >= 65535
    val = rng.integers(0, 256, idx.size).astype(np.uint8)
    g, v = twc._gap_code(idx, val)
    gj, vj = jwc._gap_code(idx, val)
    np.testing.assert_array_equal(g, gj)
    np.testing.assert_array_equal(v, vj)
    assert (g == 0xFFFF).sum() >= 3
    e = twc._gap_code(np.zeros(0, np.int64), np.zeros(0, np.uint8))
    assert e[0].size == e[1].size == 0


@pytest.mark.parametrize("bits,shape", [(4, (37, 50)), (4, (8, 70001)),
                                        (2, (37, 50)), (2, (9, 70001))])
def test_encode_plane_and_decode_equal_jax(bits, shape):
    """packed, gaps and vals equal JAX's; the device decode (escapes in the
    8 x 70001 planes) equals JAX's ``_decode4`` and the plane."""
    rng = np.random.default_rng(shape[1] + bits)
    p = spiky(rng, *shape, 0.002) if bits == 4 else tiny(rng, *shape)
    a, b = twc.encode_plane(p, bits), jwc.encode_plane(p, bits)
    for f in ("packed", "gaps", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.rows, a.cols, a.bits, a.nbytes) == (b.rows, b.cols, b.bits,
                                                  b.nbytes)
    gaps, vals = twc._pad_exceptions(a)
    gj, vj = jwc._pad_exceptions(b)
    np.testing.assert_array_equal(gaps, gj)
    got = twc._decode4(torch.from_numpy(a.packed),
                       torch.from_numpy(gaps.view(np.int16)),
                       torch.from_numpy(vals), a.rows, a.cols, bits).numpy()
    want = np.asarray(jwc._decode4(jnp.asarray(b.packed), jnp.asarray(gj),
                                   jnp.asarray(vj), rows=b.rows, cols=b.cols,
                                   bits=bits))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, p)
    np.testing.assert_array_equal(twc.upload_plane(a, CPU).numpy(), p)


def test_pack2_and_unpack2_equal_jax():
    rng = np.random.default_rng(8)
    for rows in (13, 16):
        r = rng.integers(0, 4, (rows, 19)).astype(np.uint8)
        packed = twc.pack2_rows(r)
        np.testing.assert_array_equal(packed, jwc.pack2_rows(r))
        np.testing.assert_array_equal(
            twc._unpack2(torch.from_numpy(packed), rows).numpy(),
            np.asarray(jwc._unpack2(jnp.asarray(packed), rows=rows)))
        np.testing.assert_array_equal(
            twc.upload_2bit_rows(r, CPU).numpy(), r)


def test_upload_u8_rows_round_trips_raw_and_coded():
    rng = np.random.default_rng(9)
    coded = spiky(rng, 40, 90, 0.01)
    noisy = rng.integers(0, 256, (40, 90)).astype(np.uint8)
    assert twc.encode_plane(coded) is not None
    assert twc.encode_plane(noisy) is None                # the raw branch
    for p in (coded, noisy):
        got = twc.upload_u8_rows(p, CPU)
        assert got.dtype == torch.uint8 and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), p)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jwc.upload_u8_rows(p)))


# ---- device encode, host decode ----

@pytest.mark.parametrize("bits,shape,inline", [
    (4, (37, 50), 0), (4, (37, 50), 8), (4, (30, 41), 2000),
    (2, (37, 50), 8), (2, (40, 33), 0)])
def test_encode_plane_device_equals_jax(bits, shape, inline):
    """The wire buffer (packed bytes as int32, inline prefix, int32 count)
    and the sorted exception buffer, bit for bit; caps clamp as JAX's."""
    rng = np.random.default_rng(shape[0] * 7 + bits + inline)
    p = spiky(rng, *shape, 0.05)
    cap = min(500, p.size)
    wire, exc = twc.encode_plane_device(torch.from_numpy(p), cap=cap,
                                        bits=bits, inline_exc=min(inline, cap))
    wj, ej = jwc.encode_plane_device(jnp.asarray(p), cap=cap, bits=bits,
                                     inline_exc=min(inline, cap))
    assert wire.dtype == torch.int32 and exc.dtype == torch.int32
    np.testing.assert_array_equal(wire.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(exc.numpy(), np.asarray(ej))


def test_coded_fetch_round_trips_every_branch(monkeypatch):
    """The inline case, exceptions past the inline prefix (second copy), a
    plane too noisy for the cap (raw), a row-chunked plane, and 2 bits:
    each equals the plane and JAX's CodedFetch."""
    rng = np.random.default_rng(10)
    cases = {
        "inline": (spiky(rng, 60, 130, 0.005), {}),
        # 160000 elements: 8192 inline, cap 13333, ~9000 exceptions (a noisy
        # pixel makes two)
        "past inline": (spiky(rng, 400, 400, 0.03), {}),
        "raw": (rng.integers(0, 256, (50, 70)).astype(np.uint8), {}),
        "2-bit": (tiny(rng, 45, 77), {"bits": 2}),
    }
    for name, (p, kw) in cases.items():
        got = twc.CodedFetch(torch.from_numpy(p), **kw).wait()
        np.testing.assert_array_equal(got, p, err_msg=name)
        np.testing.assert_array_equal(
            got, jwc.CodedFetch(jnp.asarray(p), **kw).wait(), err_msg=name)
    p, _ = cases["past inline"]
    wire, _ = twc.encode_plane_device(torch.from_numpy(p), cap=p.size // 12,
                                      inline_exc=8192)
    assert 8192 < int(wire[-1]) <= p.size // 12
    # row chunks: planes past _MAX_PLANE elements go in several transfers
    monkeypatch.setattr(twc, "_MAX_PLANE", 1 << 12)
    big = spiky(rng, 100, 130, 0.01)
    fetch = twc.CodedFetch(torch.from_numpy(big))
    assert len(fetch._parts) == 4
    np.testing.assert_array_equal(fetch.wait(), big)


# ---- background upload ----

@pytest.mark.parametrize("bits", [4, 2])
def test_background_upload_gated_released(bits):
    rng = np.random.default_rng(11 + bits)
    p = spiky(rng, 70, 90, 0.01) if bits == 4 else tiny(rng, 70, 90)
    bg = twc.BackgroundUpload(lambda: p, gate_wire=True, bits=bits,
                              device="cpu")
    bg.CHUNK_BYTES = 1 << 10
    bg.release_wire()
    np.testing.assert_array_equal(bg.result().numpy(), p)
    # ungated, an array in place of a callable, several chunks
    small = twc.BackgroundUpload(p, bits=bits, device="cpu")
    np.testing.assert_array_equal(small.result().numpy(), p)


def test_background_upload_raw_and_chunked(monkeypatch):
    monkeypatch.setattr(twc.BackgroundUpload, "CHUNK_BYTES", 256)
    noisy = np.random.default_rng(12).integers(0, 256, (30, 64)).astype(
        np.uint8)
    bg = twc.BackgroundUpload(noisy, device="cpu")
    bg._thread.join(timeout=60)
    assert bg._result[0] == "raw" and len(bg._result[1]) == 8
    np.testing.assert_array_equal(bg.result().numpy(), noisy)
    assert bg._result is None            # result() hands the data over


def test_background_upload_abandoned_and_error():
    """abandon() wakes a gated thread, which ends without copying; result()
    then raises; an error in the thread re-raises in result()."""
    bg = twc.BackgroundUpload(np.zeros((4, 4), np.uint8), gate_wire=True,
                              device="cpu")
    bg.abandon()
    bg._thread.join(timeout=30)
    assert not bg._thread.is_alive()
    with pytest.raises(RuntimeError, match="abandoned"):
        bg.result()

    def fail():
        raise ValueError("no plane")

    with pytest.raises(ValueError, match="no plane"):
        twc.BackgroundUpload(fail, device="cpu").result()


# ---- transfer ----

@pytest.mark.parametrize("dtype,shape", [(np.uint8, (3, 5, 7)),
                                         (np.uint8, (1100, 1000)),
                                         (np.float32, (640, 480)),
                                         (np.bool_, (9, 11))])
def test_fetch_round_trip_equals_jax(dtype, shape):
    rng = np.random.default_rng(13)
    x = (rng.integers(0, 256, shape) if dtype != np.float32
         else rng.normal(size=shape)).astype(dtype)
    got = ttransfer.fetch(torch.from_numpy(x))
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, x)
    if dtype != np.bool_:  # the JAX fetch cannot bitcast bool
        np.testing.assert_array_equal(got, jtransfer.fetch(jnp.asarray(x)))
    assert ttransfer.fetch(x) is x


def test_delta_transfers_equal_jax():
    rng = np.random.default_rng(14)
    x = smooth(rng, 2 * 30, 40 * 3).reshape(2, 30, 40, 3)
    np.testing.assert_array_equal(
        ttransfer.fetch_u8_delta(torch.from_numpy(x)), x)
    np.testing.assert_array_equal(
        ttransfer.fetch_u8_delta(torch.from_numpy(x)),
        jtransfer.fetch_u8_delta(jnp.asarray(x)))
    up = ttransfer.device_put_u8_delta(x, CPU)
    assert up.shape == x.shape and up.dtype == torch.uint8
    np.testing.assert_array_equal(up.numpy(), x)
    np.testing.assert_array_equal(
        up.numpy(), np.asarray(jtransfer.device_put_u8_delta(x)))
    d = ttransfer._delta_rows(torch.from_numpy(x[0].reshape(30, -1)))
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jtransfer._delta_rows(
            jnp.asarray(x[0].reshape(30, -1)))))
    np.testing.assert_array_equal(ttransfer._undelta_rows(d).numpy(),
                                  x[0].reshape(30, -1))
    assert jax.devices()[0].platform == "cpu"
