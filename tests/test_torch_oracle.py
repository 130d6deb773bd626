"""The port's host pieces: the JAX-free Oracle (exact rescue engine) and the
turbo mapper's capacity-overflow rescue, against sigmap_tpu.

Both oracles run the same native core source, built with the same flags
(the jax_native_from_source fixture), and the same host chaining, so they
agree exactly.  The rescue setup is tests/test_turbo.py:92-129 (S=16, K=1,
radius 0.5): the port maps the same reads at the same loci as the JAX
mapper, and without rescue it maps fewer.
"""

import dataclasses

import numpy as np

from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.oracle import Oracle as JaxOracle
from sigmap_tpu.synth import random_genome
from sigmap_tpu_torch.mapping import turbo as port
from sigmap_tpu_torch.oracle import Oracle
from _torch_util import (jax_native_from_source,  # noqa: F401 - fixtures
                         workload)


def _chain_key(c):
    a = c.anchors
    return (c.ref_index, c.direction, c.start_position, c.end_position,
            c.num_anchors, float(c.score), c.mapq,
            a["target"].tobytes(), a["query"].tobytes(), a["dist"].tobytes())


def test_port_oracle_matches_jax_package(workload, jax_native_from_source):
    cfg, idx, _, signals = workload
    mine, ref = Oracle(idx, cfg), JaxOracle(idx, cfg)
    for s in signals[:16]:
        ci, ne, chains, stopped = mine.streaming_read(s.pa)
        ci2, ne2, chains2, stopped2 = ref.streaming_read(s.pa)
        assert (ci, ne, stopped) == (ci2, ne2, stopped2)
        assert [_chain_key(c) for c in chains] == \
            [_chain_key(c) for c in chains2]
    feats = mine.features_for(signals[0].pa)
    np.testing.assert_array_equal(feats, ref.features_for(signals[0].pa))


def _loci(records):
    return {r.read_name: (r.ref_index, r.direction, r.fragment_start,
                          r.fragment_length, r.mapq)
            for r in records if r.is_mapped}


def test_port_rescue_matches_jax(workload, jax_native_from_source):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, _, reads, signals = workload
    cfg = dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, search_radius=0.5),
        runtime=dataclasses.replace(cfg.runtime, read_batch=32,
                                    num_threads=2),
    )
    idx = build_index(
        [ReferenceSequence(n, c) for n, c in random_genome(200_000, seed=11)],
        make_synthetic_pore_model(k=6, seed=0),
        cfg.index, cfg.mapping.search_radius, verbose=False,
    )
    signals = signals[:32]
    base = dict(S=16, K=1, RING=64, TILE=256)
    no_rescue = port.TurboMapper(
        idx, cfg, port.TurboParams(rescue=False, **base), device="cpu"
    ).streaming_map(signals)
    tm = port.TurboMapper(idx, cfg, port.TurboParams(**base), device="cpu")
    rescued = tm.streaming_map(signals)
    want = TurboMapper(
        idx, cfg, TurboParams(rescue=True, peaks_impl="scan", **base)
    ).streaming_map(signals)
    n_plain = sum(r.is_mapped for r in no_rescue)
    assert tm.n_rescued > 0
    assert n_plain < sum(r.is_mapped for r in rescued)
    assert _loci(rescued) == _loci(want)
