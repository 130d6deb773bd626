"""One turbo round of the port vs sigmap_tpu.mapping.turbo.turbo_round
(Pallas kernels in interpret mode) on the 200 kb workload of
tests/test_turbo.py (B=32, S=256, K=16, RING=64, TILE=256).

Each round of one batch is started in the port from exactly the state the
JAX round started from (round_state_from_numpy, tile_store_from_sweep) and
its outputs are compared.  Integers are exact; f32 scores and distance sums
agree to RTOL (XLA's CPU backend fuses multiply-adds in the d^2 and
chaining arithmetic, the port rounds each f32 operation separately like the
TPU and the CUDA kernels).  A read may differ only if one of its seeds has a
window within EPS of the radius, and such reads are at most 1% of the
batch.
"""

import numpy as np
import torch

from sigmap_tpu.index.sweep import SweepIndex
from sigmap_tpu_torch.mapping import turbo as port
from _torch_util import PARAMS, workload  # noqa: F401 - fixture

RTOL = 1e-5
EPS = 1e-4


def test_tile_store_from_sweep(workload):
    cfg, idx, _, _ = workload
    sw = SweepIndex.build(idx, cfg.mapping.search_radius, tile=256)
    st = port.tile_store_from_sweep(sw, "cpu")
    np.testing.assert_array_equal(st.tiles.numpy(), sw.tiles)
    np.testing.assert_array_equal(st.meta.numpy(), sw.meta)
    np.testing.assert_array_equal(st.cum.numpy(), sw.cum)
    assert st.radixes == sw.radixes and st.tile == 256


def _boundary_reads(idx, feats, counts, offsets, p, m, reads_idx):
    """Reads (of reads_idx) with a seed that has a window within EPS of the
    radius, by brute force over the index windows."""
    W = np.lib.stride_tricks.sliding_window_view(
        idx.values, idx.dim)[: idx.n_windows].astype(np.float32)
    seeds, _, _, _ = port.build_seeds(
        torch.from_numpy(feats), torch.from_numpy(counts),
        torch.from_numpy(offsets), p.S, m.step_size, idx.dim,
        m.min_feature_length)
    out = set()
    for b in reads_idx:
        for q in seeds[b].numpy():
            if q[0] >= 1e9:
                continue
            d2 = ((W - q[None, : idx.dim]) ** 2).sum(axis=1)
            if (np.abs(d2 - m.search_radius) < EPS).any():
                out.add(b)
                break
    return out


def test_port_rounds_match_jax(workload):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, idx, _, signals = workload
    m = cfg.mapping
    B = cfg.runtime.read_batch
    batch = signals[:B]
    jm = TurboMapper(idx, cfg, TurboParams(peaks_impl="scan", **PARAMS))
    feats_all, counts_all, n_full_d, n_full, _NC = jm._prepare_batch(batch)
    p = port.TurboParams(**PARAMS)
    sw = SweepIndex.build(idx, m.search_radius, tile=p.TILE)
    store = port.tile_store_from_sweep(sw, "cpu")
    state = jm._init_state(B)
    nf = torch.from_numpy(np.asarray(n_full, np.int32))
    differ, explained = set(), set()
    rounds = 0
    done = n_full == 0
    while not done.all():
        feats_r, counts_r = (np.asarray(x) for x in jm._slice_chunk(
            feats_all, counts_all, np.int32(rounds)))
        host = [np.asarray(x) for x in state[:4]]
        carry = [np.asarray(c) for c in state[4]]
        st = port.round_state_from_numpy(
            *host, carry, np.asarray(state[5]), np.asarray(state[6]), "cpu")
        got, counts, sig = port.turbo_round(
            store, torch.from_numpy(feats_r), torch.from_numpy(counts_r), nf,
            st, p, m.step_size, m.search_radius, idx.dim, cfg.chain, m)
        out = jm._run_round(feats_r, counts_r, n_full_d, *state)
        w_carry = [np.asarray(c) for c in out[4]]
        ints = [(got.chunk_idx, out[0]), (got.done, out[1]),
                (got.stopped, out[2]), (got.offsets, out[3]),
                (got.rb_i, out[6])] + [(got.carry[k], w_carry[k])
                                       for k in (0, 1, 2, 4, 5, 6)]
        bad = np.zeros(B, bool)
        for g, w in ints:
            bad |= (g.numpy() != np.asarray(w)).reshape(-1, B).any(axis=0)
        for g, w in ((got.rb_f, out[5]), (got.carry[3], w_carry[3]),
                     (got.carry[7], w_carry[7])):
            g, w = g.numpy(), np.asarray(w)
            close = np.abs(g - w) <= RTOL * np.abs(w) + RTOL
            bad |= ~close.reshape(-1, B).all(axis=0)
        # host signal: per-read done flags (compared above), overflow flags
        np.testing.assert_array_equal(sig.numpy()[B:], np.asarray(out[9])[B:])
        if bad.any():
            rows = np.nonzero(bad)[0]
            differ |= set(rows.tolist())
            explained |= _boundary_reads(idx, feats_r, counts.numpy(),
                                         host[3], p, m, rows)
        state = out[:7]
        done = np.asarray(out[1])
        rounds += 1
    assert rounds >= 2
    assert differ <= explained, f"reads {sorted(differ - explained)} differ"
    assert len(differ) <= 0.01 * B
