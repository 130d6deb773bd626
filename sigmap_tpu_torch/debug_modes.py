"""Debug modes of the reference driver: DTWAlign, CWTAlign, FAST5ToText,
EventsToText.

Counterpart of ``sigmap_tpu/debug_modes.py`` (sigmap.cc:882-997,
1198-1257), with the same arguments, return values and text.  The JAX
package runs each (read, reference) sDTW as a Python double loop
(``sdtw_np``); here every pair of a mode goes into batched calls of kernel
B5 (``ops.sdtw_kernel.sdtw``) on ``device``, padded and ragged, and the
results are printed in the reference's order (read-major).  B5 computes the
same recurrence with the same f32 rounding, so the text is the same.
``fast5_to_text`` and ``events_to_text`` are host work, as in the JAX
package.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .config import SigmapConfig
from .index.build import zscore_f64
from .io.fasta import read_fasta
from .io.pore_model import PoreModel
from .io.signals import load_all_read_signals
from .ops.cwt import cwt_feature_signal
from .ops.sdtw_kernel import plan, sdtw, sm_count
from .signal import events_ref

# device memory one batch of sDTW pairs may take: targets, queries and the
# scratch of the kernel's launch plan, 4 bytes each (64 reads of 3000 bases
# against a 48.5 kb reference take ~32 MB)
SDTW_BATCH_BYTES = 1 << 30

# sdtw_np's answers where B5 has no valid last-column cell: an empty query
# ends at target position 1 at distance 0, an empty target keeps its init
_NP_INIT = np.float32(3.4e38)


def _reference_signals(ref_path: str, pore_path: str):
    pore = PoreModel.load(pore_path)
    seqs = read_fasta(ref_path)
    return seqs, [pore.expected_signal(s.codes) for s in seqs]


def dtw_pairs(ref_path: str, pore_path: str, sig_dir: str):
    """dtw-align's pairs in print order: (labels [(read_id, ref_name)],
    targets [z-scored reference signal], queries [z-scored read signal])."""
    seqs, ref_sigs = _reference_signals(ref_path, pore_path)
    ref_norm = [zscore_f64(r) for r in ref_sigs]
    labels, targets, queries = [], [], []
    for s in load_all_read_signals(sig_dir):
        read_norm = zscore_f64(s.pa)
        for seq, rn in zip(seqs, ref_norm):
            labels.append((s.read_id, seq.name))
            targets.append(rn)
            queries.append(read_norm)
    return labels, targets, queries


def cwt_pairs(ref_path: str, pore_path: str, sig_dir: str,
              cwt_scale0: float = 1.0):
    """cwt-align's pairs in print order: (labels, targets [reference CWT
    features at scale0], queries [read features at 8*scale0], rpos
    [reference feature positions])."""
    seqs, ref_sigs = _reference_signals(ref_path, pore_path)
    ref_feats = [cwt_feature_signal(rs, cwt_scale0) for rs in ref_sigs]
    labels, targets, queries, rpos = [], [], [], []
    for s in load_all_read_signals(sig_dir):
        feats, _pos = cwt_feature_signal(s.pa, 8 * cwt_scale0)
        for seq, (rf, rp) in zip(seqs, ref_feats):
            labels.append((s.read_id, seq.name))
            targets.append(rf)
            queries.append(feats)
            rpos.append(rp)
    return labels, targets, queries, rpos


def batch_bytes(n: int, T: int, Q: int, sms: int) -> int:
    """Device bytes of one B5 call on n pairs padded to T and Q on a card of
    `sms` SMs: targets and queries, and the scratch that ``plan`` allocates
    for them."""
    return 4 * (T + Q) * n + plan(n, T, Q, sms).scratch_bytes


def batch_bounds(targets, queries, sms: int,
                 budget: int = SDTW_BATCH_BYTES):
    """Split pairs into consecutive [lo, hi) batches whose padded inputs and
    scratch (``batch_bytes``) stay within ``budget``."""
    out, lo, tmax, qmax = [], 0, 0, 0
    for k, (t, q) in enumerate(zip(targets, queries)):
        t2, q2 = max(tmax, len(t)), max(qmax, len(q))
        if k > lo and batch_bytes(k + 1 - lo, t2, q2, sms) > budget:
            out.append((lo, k))
            lo, t2, q2 = k, len(t), len(q)
        tmax, qmax = t2, q2
    if lo < len(targets):
        out.append((lo, len(targets)))
    return out


def pack_pairs(targets, queries, device):
    """Ragged pairs -> (targets [B, T], t_len [B], queries [B, Q], q_len [B])
    on ``device``, zero-padded to the longest of each."""
    B = len(targets)
    t_len = np.array([len(t) for t in targets], np.int32)
    q_len = np.array([len(q) for q in queries], np.int32)
    tp = np.zeros((B, max(1, int(t_len.max(initial=0)))), np.float32)
    qp = np.zeros((B, max(1, int(q_len.max(initial=0)))), np.float32)
    for k, (t, q) in enumerate(zip(targets, queries)):
        tp[k, : len(t)] = t
        qp[k, : len(q)] = q
    dev = torch.device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (tp, t_len, qp, q_len))


def sdtw_pairs(targets, queries, device):
    """sDTW of every (targets[k], queries[k]) pair with B5 on ``device``
    -> (best [P] f32, end [P] i32) as numpy, equal to ``sdtw_np``."""
    best = np.zeros(len(targets), np.float32)
    end = np.zeros(len(targets), np.int32)
    dev = torch.device(device)
    # the plain version on the CPU has no launch: count a one-SM card's plan
    sms = sm_count(dev) if dev.type == "cuda" else 1
    for lo, hi in batch_bounds(targets, queries, sms):
        b, e = sdtw(*pack_pairs(targets[lo:hi], queries[lo:hi], device))
        best[lo:hi] = b.cpu().numpy()
        end[lo:hi] = e.cpu().numpy()
    for k, (t, q) in enumerate(zip(targets, queries)):
        if len(t) == 0:
            best[k], end[k] = _NP_INIT, -1
        elif len(q) == 0:
            best[k], end[k] = 0.0, 1
    return best, end


def dtw_align(ref_path: str, pore_path: str, sig_dir: str, out=sys.stderr,
              *, device):
    """Whole-signal sDTW of every read against every reference
    (sigmap.cc:882-930), on ``device``."""
    labels, targets, queries = dtw_pairs(ref_path, pore_path, sig_dir)
    best, end = sdtw_pairs(targets, queries, device)
    results = []
    for (rid, name), dist, e in zip(labels, best, end):
        dist, e = float(dist), int(e)
        print(
            f"Read name: {rid}, reference name: {name}\n"
            f"DTW distance: {dist}, mapping_end_position: {e}.",
            file=out,
        )
        results.append((rid, name, dist, e))
    return results


def cwt_align(ref_path: str, pore_path: str, sig_dir: str,
              cwt_scale0: float = 1.0, out=sys.stderr, *, device):
    """CWT-feature sDTW (sigmap.cc:932-997): reference features at scale0,
    read features at 8*scale0, on ``device``."""
    labels, targets, queries, rpos = cwt_pairs(ref_path, pore_path, sig_dir,
                                               cwt_scale0)
    best, end = sdtw_pairs(targets, queries, device)
    results = []
    for (rid, name), dist, e, rp in zip(labels, best, end, rpos):
        dist, e = float(dist), int(e)
        rough = int(rp[e - 1]) if 0 < e <= len(rp) else -1
        print(
            f"Read name: {rid}, reference name: {name}\n"
            f"DTW distance: {dist}, feature_mapping_end_position: {e}, "
            f"rough mapping end postion: {rough}.",
            file=out,
        )
        results.append((rid, name, dist, e, rough))
    return results


def fast5_to_text(sig_dir: str, output_prefix: str) -> str:
    """Dump raw pA samples, one per line (sigmap.cc:1236-1257)."""
    path = output_prefix + "_fast5"
    with open(path, "w") as f:
        for s in load_all_read_signals(sig_dir):
            for v in s.pa:
                f.write(f"{v:.6f}\n".replace("-0.000000", "0.000000"))
    return path


def events_to_text(sig_dir: str, output_prefix: str,
                   config: SigmapConfig = SigmapConfig()) -> str:
    """Dump z-scored event means, one per line (sigmap.cc:1198-1234)."""
    path = output_prefix + "_event"
    with open(path, "w") as f:
        for s in load_all_read_signals(sig_dir):
            ps, pss = events_ref.prefix_sums(s.pa)
            L = len(s.pa)
            t1 = events_ref.tstat_centered(s.pa, L,
                                           config.event.window_length1)
            t2 = events_ref.tstat_centered(s.pa, L,
                                           config.event.window_length2)
            peaks = events_ref.detect_peaks(t1, t2, L, config.event)
            _, means, _ = events_ref.events_from_peaks(
                peaks, ps, pss, L, signal=s.pa
            )
            norm = events_ref.zscore(means)
            for v in norm:
                f.write(f"{v:.6f}\n")
    return path
