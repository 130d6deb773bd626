"""Command-line interface of the PyTorch port (flags of sigmap_tpu.cli).

  index:  python -m sigmap_tpu_torch.cli -i -r ref.fa -p pore.model -o prefix
  map:    python -m sigmap_tpu_torch.cli -m -r ref.fa -p pore.model \
              -x prefix -s signal_dir -o out.paf [--read-batch 2048] ...

``-i`` runs the reference's JAX-free index build (``sigmap_tpu.cli.run_index``)
on the port's own build of the native core.  ``-m`` maps with the port's
turbo engine on the CUDA device and fails when there is none.
``--engine exact`` and ``--batch-mode`` are not ported yet and exit with an
error rather than running something else.
"""

from __future__ import annotations

import os
import sys
import time

from sigmap_tpu.cli import build_parser, make_config, run_index

from . import _build

# figures of the last -m run in this process (reads, rescues, seconds)
LAST_MAP: dict = {}


def run_map(args) -> int:
    import torch

    from sigmap_tpu.index.build import SignalIndex
    from sigmap_tpu.io.paf import PAFWriter
    from sigmap_tpu.io.signals import load_all_read_signals

    from .mapping.turbo import TurboMapper

    for flag, name in (
        (args.ref, "reference"), (args.pore_model, "pore model"),
        (args.ref_index, "reference index"), (args.sig_dir, "signal data"),
        (args.output, "output"),
    ):
        if not flag:
            print(f"No {name} specified!", file=sys.stderr)
            return 1
    if not torch.cuda.is_available():
        print("sigmap_tpu_torch: no CUDA device; mapping needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_config(args)
    t0 = time.time()
    if os.path.exists(args.ref_index + ".sidx.npz") or args.ref_index.endswith(
        (".sidx", ".npz")
    ):
        idx = SignalIndex.load(args.ref_index)
    elif os.path.exists(args.ref_index + ".pt") or args.ref_index.endswith(".pt"):
        # reference-compatible .pt point cloud: rebuild the grid on the fly
        from sigmap_tpu.io.fasta import read_fasta

        seqs = read_fasta(args.ref)
        pt = (args.ref_index if args.ref_index.endswith(".pt")
              else args.ref_index + ".pt")
        idx = SignalIndex.load_pt(
            pt, cfg.index, cfg.mapping.search_radius,
            [s.name for s in seqs], [s.length for s in seqs],
        )
    else:
        idx = SignalIndex.load(args.ref_index)
    signals = load_all_read_signals(
        args.sig_dir, cfg.mapping.pa_lo, cfg.mapping.pa_hi
    )
    print(f"Loaded {len(signals)} reads.", file=sys.stderr)
    mapper = TurboMapper(idx, cfg, device="cuda")
    t_map = time.time()
    records = mapper.streaming_map(signals)
    t_map = time.time() - t_map
    mapper.close()
    writer = PAFWriter(args.output, idx.ref_names, idx.ref_lengths)
    for rec in records:
        writer.append(rec)
    n = writer.finalize()
    LAST_MAP.clear()
    LAST_MAP.update(reads=len(signals), records=n, map_s=t_map,
                    rescued=mapper.n_rescued,
                    rescued_mapped=mapper.n_rescued_mapped)
    print(
        f"Finished mapping in {time.time() - t0:.1f}s "
        f"(streaming {t_map:.3f}s), # reads: {len(signals)}, "
        f"# records: {n}, rescued: {mapper.n_rescued}",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.debug_mode:
        print("sigmap_tpu_torch: --debug-mode is not ported yet",
              file=sys.stderr)
        return 2
    if args.build_index:
        _build.native()
        return run_index(args)
    if args.map:
        if args.batch_mode or args.engine == "exact":
            what = "--batch-mode" if args.batch_mode else "--engine exact"
            print(f"sigmap_tpu_torch: {what} is not yet ported",
                  file=sys.stderr)
            return 2
        _build.native()
        return run_map(args)
    build_parser().print_help(sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
