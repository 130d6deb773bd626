"""Port of the turbo engine vs sigmap_tpu.mapping.turbo on the 200 kb
workload of tests/test_turbo.py (B=32, S=256, K=16, RING=64, TILE=256).

* slice: TurboMapper(device="cpu").streaming_map gives the JAX mapper's
  PAF records field for field, except the mt: timing tag and the last
  printed digits of the float tags: XLA's CPU backend fuses
  multiply-adds in the d^2 and chaining arithmetic, the port rounds each
  f32 operation separately like the TPU and the CUDA kernels.  Scores agree
  within RTOL, and ad (mean d^2 over the best chain, a sum of ~70 f32
  distances each rounded differently) within AD_RTOL; measured maxima on
  this workload are 8e-6 and 1.2e-4.
"""

import dataclasses

from sigmap_tpu_torch.mapping import turbo as port
from _torch_util import PARAMS, workload  # noqa: F401 - fixture

RTOL = 1e-5
AD_RTOL = 3e-4


def _tags(rec):
    return dict(t.split(":", 1) for t in rec.tags.split("\t"))


def test_port_streaming_map_matches_jax(workload):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, idx, reads, signals = workload
    got = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                           device="cpu").streaming_map(signals)
    want = TurboMapper(idx, cfg, TurboParams(peaks_impl="scan", **PARAMS)
                       ).streaming_map(signals)
    assert len(got) == len(want) == len(signals)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gt, wt = _tags(g), _tags(w)
        gd.pop("tags"), wd.pop("tags")
        assert gd == wd, (gd, wd)
        assert gt.keys() == wt.keys()
        for k in gt:
            if k == "mt":
                continue
            kind, gv = gt[k].split(":")
            _, wv = wt[k].split(":")
            if kind == "f":
                tol = (AD_RTOL if k == "ad" else RTOL) * abs(float(wv))
                assert abs(float(gv) - float(wv)) <= tol + 2e-6, (k, gv, wv)
            else:
                assert gv == wv, (g.read_name, k, gv, wv)
    by_name = {r.read_name: r for r in got}
    correct = sum(
        1 for r in reads
        if by_name[r.read_id].is_mapped
        and by_name[r.read_id].direction == r.strand
        and by_name[r.read_id].fragment_start < r.ref_end
        and by_name[r.read_id].fragment_start
        + by_name[r.read_id].fragment_length > r.ref_start
    )
    assert correct >= len(reads) - 2
