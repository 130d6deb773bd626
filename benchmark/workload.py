"""A cell's data files and its set-up: configuration, traffic, genome,
index, mapper and read pool.

Everything that belongs to one configuration or one traffic mix is a JSON
file of its own (``configs/<config>.json``, ``traffic/<traffic>.json``),
found by the names in ``BENCHMARK.json``; nothing here names a cell.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from . import synthgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, here: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration's and traffic's
    files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(os.path.dirname(here), cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(here, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic)


@dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    pore: synthgen.Pore
    genome: list            # [(name, codes)]
    pools: list             # the pool's parts: [[(read_id, pa)], ...]
    truths: dict            # read_id -> synthgen.Truth


def make_inputs(cell: Cell, seed: int, device="cpu") -> Inputs:
    """Genome and read pool of ``cell`` for ``seed``: ``pool_calls`` parts
    (a traffic parameter) of ``reads_per_call`` reads each, which the
    window's calls take in turn, so consecutive calls never carry the same
    reads.  The reads' dwells and noise are drawn on ``device``."""
    c, t = cell.config, cell.traffic
    pm = c["pore_model"]
    if pm["kind"] != "synthetic":
        raise ValueError(f"unknown pore model kind {pm['kind']!r}")
    pore = synthgen.synthetic_pore(pm["k"], pm["seed"])
    genome = synthgen.random_contigs(c["contigs"],
                                     synthgen.rng_for(seed, "genome"))
    other = None
    if t["off_target_share"] > 0:
        other = synthgen.random_contigs(
            [("off_target", t["off_target_genome_bases"])],
            synthgen.rng_for(seed, "off_genome"))
    # each part holds the same lengths and the same off-target share: the
    # quantiles of the length distribution, with every k-th of them (in
    # length order) off target, so a seed changes only the order and the
    # bases, not the work
    n = t["reads_per_call"]
    parts = t["pool_calls"]
    lengths = np.sort(synthgen.read_lengths(t["read_bases"], n))
    off_part = np.zeros(n, bool)
    n_off = round(t["off_target_share"] * n)
    if n_off:
        off_part[np.round(np.linspace(0, n - 1, n_off)).astype(int)] = True
    rng = synthgen.rng_for(seed, "pool")
    order = np.concatenate([p * n + rng.permutation(n) for p in range(parts)])
    bases = np.tile(lengths, parts)[order]
    off = np.tile(off_part, parts)[order]
    ids, pas, truths = synthgen.simulate_pool(
        pore, genome, other, bases, off, rng, t["samples_per_base"],
        t["noise_pa"], device)
    reads = list(zip(ids, pas))
    return Inputs(pore, genome,
                  [reads[p * n: (p + 1) * n] for p in range(parts)],
                  {tr.read_id: tr for tr in truths})


def sigmap_config(cell: Cell):
    """The program's SigmapConfig for the cell (defaults, the traffic's
    read batch and threads)."""
    from sigmap_tpu_torch.config import RuntimeConfig, SigmapConfig

    t = cell.traffic
    return SigmapConfig(runtime=RuntimeConfig(read_batch=t["read_batch"],
                                              num_threads=t["threads"]))


def build_mapper(cell: Cell, inputs: Inputs):
    """The system under test, built as ``cli.run_index`` and ``cli.run_map``
    build it: the port's index builder on the genome, its rescue oracle and
    ``TurboMapper(index, cfg, params, device="cuda")``.  Returns
    (mapper, the signals of each part of the pool)."""
    from sigmap_tpu_torch import _build
    from sigmap_tpu_torch.index.build import build_index
    from sigmap_tpu_torch.io.fasta import ReferenceSequence
    from sigmap_tpu_torch.io.pore_model import PoreModel
    from sigmap_tpu_torch.io.signals import ReadSignal
    from sigmap_tpu_torch.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu_torch.oracle import Oracle

    _build.native()
    cfg = sigmap_config(cell)
    lm = inputs.pore.level_mean
    zero = np.zeros_like(lm)
    pore = PoreModel(inputs.pore.k, lm, zero, zero, zero)
    seqs = [ReferenceSequence(name, codes) for name, codes in inputs.genome]
    index = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                        verbose=False)
    params = TurboParams(**cell.config["turbo_params"])
    oracle = Oracle(index, cfg) if params.rescue else None
    mapper = TurboMapper(index, cfg, params, device="cuda", oracle=oracle)
    parts = [[ReadSignal(rid, synthgen.DIGITISATION, synthgen.DAC_RANGE,
                         synthgen.DAC_OFFSET, pa) for rid, pa in part]
             for part in inputs.pools]
    return mapper, parts
