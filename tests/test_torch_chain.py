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
from _torch_util import cuda_device  # noqa: F401 - fixture
from test_chain_fused import DIM, RADIUS, _random_case

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import chain_adversarial  # noqa: E402

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
    """The kernel holds a read's anchors and ring in a block's shared
    memory: the wrapper's check takes the main path's shape, refuses the
    first size that does not fit, and TurboParams.check names the limit on
    a GPU only (the plain version on the CPU takes any size)."""
    from sigmap_tpu_torch.mapping.turbo import TurboParams
    from sigmap_tpu_torch.ops.chain_fused import (SMEM_LIMIT, check_fits,
                                                  max_new_rows,
                                                  shared_memory_bytes)

    assert shared_memory_bytes(768 + 256 * 8, 768, 768, 8) == 72_356
    for carry, ring, kb in ((768, 768, 8), (768, 768, 1), (16, 16, 32)):
        n = max_new_rows(carry, ring, kb)
        assert n % kb == 0
        check_fits(carry + n, carry, ring, kb)
        assert shared_memory_bytes(carry + n, carry, ring, kb) <= SMEM_LIMIT
        with pytest.raises(ValueError, match=f"at most {n} new rows"):
            check_fits(carry + n + kb, carry, ring, kb)
    assert max_new_rows(768, 768, 8) == 11_744
    TurboParams().check("cuda")
    TurboParams(S=1024, K=8).check("cuda")
    TurboParams(S=1024, K=16).check("cpu")
    with pytest.raises(ValueError, match=r"TurboParams\(S=1024, K=16"):
        TurboParams(S=1024, K=16).check("cuda")


def _kernel_equals_plain(args, dev, **kw):
    from sigmap_tpu_torch.ops.chain_fused import chain_fused_plain

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    k = port_chain_fused(*args, **kw)
    p = chain_fused_plain(*args, **kw)
    for a, b in zip([k[0], k[1], *k[2]], [p[0], p[1], *p[2]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_chain_fused_kernel_matches_plain_on_gpu(cuda_device):
    rng = np.random.default_rng(3)
    _kernel_equals_plain(_random_case(rng, 64 + 8 * 16, 70, 64), cuda_device,
                         radius=RADIUS, dim=DIM, ring=64,
                         cfg=ChainingConfig(), kb=8)


@pytest.mark.gpu
@pytest.mark.parametrize("kb", [1, 4, 8])
def test_chain_fused_kernel_matches_plain_on_adversarial_reads(cuda_device,
                                                               kb):
    args, kw = chain_adversarial(0)
    _kernel_equals_plain(args, cuda_device, cfg=ChainingConfig(), kb=kb,
                         **kw)
