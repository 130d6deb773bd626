"""Port of chain_fused (kernel B4's plain version) vs the JAX kernel in
interpret mode and its numpy twin chain_fused_ref.

Same randomized anchors as tests/test_chain_fused.py.  Integer outputs and
integer ring fields are exact.  f32 outputs (scores, sumd) agree to 1e-5
relative: XLA's CPU backend contracts `score + min(..) * coef` into a fused
multiply-add and chain_fused_ref evaluates coef/cand in float64, while the
port rounds every f32 operation separately (as the TPU and the CUDA kernel
do); the measured difference is one or two ulps on a few ring scores.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigmap_tpu.config import ChainingConfig
from sigmap_tpu.ops.chain_fused import chain_fused, chain_fused_ref
from sigmap_tpu_torch.ops.chain_fused import chain_fused as port_chain_fused
from test_chain_fused import DIM, RADIUS, _random_case

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import ADV_WINDOW_ROWS, chain_adversarial  # noqa: E402

RTOL = 1e-5


def _port(args, **kw):
    sum_f, sum_i, carry = port_chain_fused(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    return sum_f.numpy(), sum_i.numpy(), [c.numpy() for c in carry]


def _check(got, want_f, want_i, want_carry):
    sum_f, sum_i, carry = got
    np.testing.assert_array_equal(sum_i[:6], np.asarray(want_i)[:6])
    np.testing.assert_allclose(sum_f[:4], np.asarray(want_f)[:4], rtol=RTOL,
                               atol=RTOL)
    for k, (g, w) in enumerate(zip(carry, want_carry)):
        w = np.asarray(w)
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL,
                                       err_msg=f"carry field {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"carry field {k}")


@pytest.mark.parametrize("ring", [16, 64])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kb", [1, 8])
def test_port_chain_fused_matches_jax(seed, ring, kb):
    rng = np.random.default_rng(seed)
    args = _random_case(rng, 96, 5, 16)
    kw = dict(radius=RADIUS, dim=DIM, ring=ring, cfg=ChainingConfig(), kb=kb)
    got = _port(args, **kw)
    jf, ji, jc = chain_fused(*(jnp.asarray(a) for a in args),
                             interpret=True, **kw)
    _check(got, jf, ji, jc)
    rf, ri, rc = chain_fused_ref(*args, **kw)
    _check(got, rf, ri, rc)


def test_port_chain_fused_turbo_shape():
    """CARRY == RING and kb = K, the turbo layout, on a wider batch."""
    rng = np.random.default_rng(5)
    args = _random_case(rng, 32 + 12 * 4, 9, 32)
    kw = dict(radius=RADIUS, dim=DIM, ring=32, cfg=ChainingConfig(), kb=4)
    got = _port(args, **kw)
    jf, ji, jc = chain_fused(*(jnp.asarray(a) for a in args),
                             interpret=True, **kw)
    _check(got, jf, ji, jc)


@pytest.mark.parametrize("kb", [1, 4, 8])
def test_port_chain_fused_adversarial(kb):
    """chip_smoke.py's adversarial reads (one rule of the DP a read, see
    chain_adversarial) against the JAX package's numpy twin; on the card
    chip_smoke.py holds the kernel to the plain version on the same reads."""
    args, kw = chain_adversarial(0)
    kw = dict(kw, cfg=ChainingConfig(), kb=kb)
    ring = kw["ring"]
    got = _port(args, **kw)
    _check(got, *chain_fused_ref(*args, **kw))
    sum_f, sum_i, carry = got
    valid = (args[3] >= 0).sum(axis=0)
    # read 0: two slots tie, the lowest wins (its chain start is t - 10)
    assert sum_f[0, 0] == 13.0 and sum_i[1, 0] == 90
    # read 1: the ring wrapped; every slot holds one of the last RING rows
    assert valid[1] > 2 * ring and (carry[1][:, 1] >= args[1][-ring, 1]).all()
    # read 2: whole blocks of one g; read 3: invalid blocks, then one valid
    assert (args[3][ring:ring + 8, 2] == 1).all() and sum_i[0, 2] == 1
    assert (args[3][ring:-8, 3] < 0).all() and sum_i[0, 3] == 0
    # read 4: an empty carry; read 5: nothing valid
    assert (args[3][:ring, 4] < 0).all() and sum_i[5, 4] > 1
    assert valid[5] == 0 and sum_i[0, 5] == -1 and sum_f[0, 5] < -1e29
    assert (carry[2][:, 5] == -2).all()
    # read 6: three chains with one score
    assert sum_f[0, 6] == sum_f[1, 6] == sum_f[3, 6] > 10


def test_port_chain_fused_empty():
    """All-invalid anchors: NEG scores, -1 group, empty carry."""
    A, B, CARRY = 32, 3, 8
    z_i = torch.zeros((A, B), dtype=torch.int32)
    z_f = torch.zeros((A, B), dtype=torch.float32)
    g = torch.full((A, B), -1, dtype=torch.int32)
    c_f = torch.zeros((CARRY, B), dtype=torch.float32)
    c_i = torch.zeros((CARRY, B), dtype=torch.int32)
    sum_f, sum_i, carry = port_chain_fused(
        z_i, z_i, z_f, g, c_f, c_i, c_i, c_i, c_f,
        radius=RADIUS, dim=DIM, ring=16,
    )
    assert float(sum_f[0].max()) < -1e29
    assert (sum_i[0] == -1).all()
    assert (carry[2] == -2).all()


def test_port_chain_fused_rejects_other_devices():
    """The wrapper takes CPU (plain version) or CUDA (kernel), nothing
    else."""
    x = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        port_chain_fused(x, x, x.float(), x, x.float(), x, x, x, x.float(),
                         radius=RADIUS)


def test_port_chain_fused_refuses_reads_beyond_shared_memory():
    """The kernel holds a read's ring in a block's shared memory beside its
    anchor rows: the whole read where it fits (the operating point, at its
    earlier size), else windows of rows whose size does not grow with A, by
    default the largest with which three blocks share an SM.
    Only a ring too large for the smallest window (kb rows) is refused, with
    the largest ring that fits named, by the wrapper's check and by
    TurboParams.check on a GPU (the plain version on the CPU takes any
    size)."""
    from sigmap_tpu_torch.mapping.turbo import TurboParams
    from sigmap_tpu_torch.ops.chain_fused import (SM_SMEM, SMEM_LIMIT,
                                                  check_fits, default_window,
                                                  largest_window, max_ring,
                                                  shared_memory_bytes)

    assert shared_memory_bytes(768 + 256 * 8, 768, 768, 8) == 72_356
    assert check_fits(768 + 256 * 8, 768, 768, 8) == 0
    A = 768 + 1024 * 16
    W = check_fits(A, 768, 768, 16)
    assert W == default_window(768, 16) and W % 16 == 0
    assert shared_memory_bytes(A, 768, 768, 16) > SMEM_LIMIT
    smem = shared_memory_bytes(A, 768, 768, 16, W)
    assert 3 * (smem + 1024) <= SM_SMEM < 3 * (smem + 32 * 16 + 4 + 1024)
    big_w = largest_window(768, 16)
    assert big_w > W
    big_smem = shared_memory_bytes(A, 768, 768, 16, big_w)
    assert big_smem <= SMEM_LIMIT < big_smem + 32 * 16 + 4
    for more in (16, 10_000 * 16, 1 << 20):
        assert check_fits(A + more, 768, 768, 16) == W
        assert shared_memory_bytes(A + more, 768, 768, 16, W) == smem
    assert check_fits(96, 16, 16, 8, window_rows=16) == 16
    with pytest.raises(ValueError, match="multiple of kb"):
        check_fits(96, 16, 16, 8, window_rows=12)
    for kb in (1, 8, 16, 32):
        ring = max_ring(kb)
        assert check_fits(ring + 64 * kb, ring, ring, kb) == kb
        assert default_window(ring, kb) == largest_window(ring, kb) == kb
        with pytest.raises(ValueError, match=f"at most {ring} ring slots"):
            check_fits(ring + 1 + 64 * kb, ring + 1, ring + 1, kb)
    TurboParams().check("cuda")
    TurboParams(S=1024, K=16).check("cuda")
    TurboParams(S=1024, K=32).check("cuda")
    big = max_ring(8) + 1
    TurboParams(RING=big).check("cpu")
    with pytest.raises(ValueError, match=rf"TurboParams\(S=256, K=8, "
                                         rf"RING={big}"):
        TurboParams(RING=big).check("cuda")


@pytest.mark.parametrize("kb", [1, 4, 8])
def test_port_chain_fused_adversarial_windows(kb):
    """chip_smoke.py's reads 8-12, whose rules cross the kernel's windows of
    ADV_WINDOW_ROWS new rows (the card holds the windowed kernel to the
    plain version on them), against the JAX package's numpy twin; what each
    read sets up holds at every kb (one chain anchor an 8-row block)."""
    args, kw = chain_adversarial(0)
    kw = dict(kw, cfg=ChainingConfig(), kb=kb)
    got = _port(args, **kw)
    _check(got, *chain_fused_ref(*args, **kw))
    sum_f, sum_i, carry = got
    ring = kw["ring"]
    W = ADV_WINDOW_ROWS
    assert (args[3].shape[0] - ring) % W == 0 and W % kb == 0
    t = args[0]

    def window(b, te):       # the window of the new row of read b ending at te
        rows = np.nonzero((t[ring:, b] == te) & (args[3][ring:, b] >= 0))[0]
        return int(rows[0]) // W

    # 8: the ring wrapped while the pushes crossed windows 0 -> 1 -> 2
    assert (args[3][ring:, 8] >= 0).sum() > 2 * ring
    assert window(8, sum_i[2, 8]) == 2
    # 9: chains 1, 2, 3 of 42, 32, 28 end in windows 0, 1 and 3
    np.testing.assert_array_equal(sum_f[[0, 1, 3], 9], [42, 32, 28])
    assert sum_i[0, 9] == 0 and window(9, sum_i[2, 9]) == 0
    # 10: equal chains of 32 in windows 0 and 2: the one in window 0 leads
    assert sum_f[0, 10] == sum_f[1, 10] == 32 and sum_i[0, 10] == 0
    # 11: one chain through windows 0 and 2, window 1 all invalid: its
    # carried seed (n 3) and four new anchors
    assert (args[3][ring + W:ring + 2 * W, 11] < 0).all()
    assert sum_f[0, 11] == 44 and sum_i[5, 11] == 3 + 4
    assert window(11, sum_i[2, 11]) == 2
    # 12: chain 1 starts at its carried rows (500); the carried row of 30
    # on the other strand inside its interval is no chain 2 (12 is)
    assert sum_i[1, 12] == 500 and sum_f[0, 12] == 46
    assert sum_f[1, 12] == 12
