"""Command-line interface of the PyTorch port (flags of sigmap_tpu.cli).

  index:  python -m sigmap_tpu_torch.cli -i -r ref.fa -p pore.model -o prefix
  map:    python -m sigmap_tpu_torch.cli -m -r ref.fa -p pore.model \
              -x prefix -s signal_dir -o out.paf [--read-batch 2048] ...
  debug:  python -m sigmap_tpu_torch.cli --debug-mode dtw-align \
              -r ref.fa -p pore.model -s signal_dir

``-i`` runs the reference's JAX-free index build (``sigmap_tpu.cli.run_index``)
on the port's own build of the native core.  ``-m`` maps on the CUDA device
with the turbo engine (default), the exact streaming engine
(``--engine exact``) or whole-read batch mode (``--batch-mode``), and fails
when there is no CUDA device.  ``--debug-mode dtw-align`` and ``cwt-align``
run their sDTW (kernel B5) on the CUDA device and fail without one;
``fast5-to-text`` and ``events-to-text`` are host work and run anywhere.
"""

from __future__ import annotations

import os
import sys
import time

from sigmap_tpu.cli import build_parser, make_config, run_index

from . import _build

# figures of the last -m run in this process (reads, rescues, seconds)
LAST_MAP: dict = {}


def _no_gpu(what: str) -> int:
    print(f"sigmap_tpu_torch: no CUDA device; {what} needs a GPU",
          file=sys.stderr)
    return 2


def run_map(args) -> int:
    import torch

    from sigmap_tpu.index.build import SignalIndex
    from sigmap_tpu.io.paf import PAFWriter
    from sigmap_tpu.io.signals import load_all_read_signals

    for flag, name in (
        (args.ref, "reference"), (args.pore_model, "pore model"),
        (args.ref_index, "reference index"), (args.sig_dir, "signal data"),
        (args.output, "output"),
    ):
        if not flag:
            print(f"No {name} specified!", file=sys.stderr)
            return 1
    if not torch.cuda.is_available():
        return _no_gpu("mapping")
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
    # engine dispatch as in sigmap_tpu.cli.run_map
    turbo = not (args.batch_mode or args.engine == "exact")
    if turbo:
        from .mapping.turbo import TurboMapper

        mapper = TurboMapper(idx, cfg, device="cuda")
        run = mapper.streaming_map
    else:
        from .mapping.driver import Mapper

        mapper = Mapper(idx, cfg, device="cuda")
        run = mapper.map_reads if args.batch_mode else mapper.streaming_map
    t_map = time.time()
    records = run(signals)
    torch.cuda.synchronize()
    t_map = time.time() - t_map
    rescued = (0, 0)
    if turbo:
        mapper.close()
        rescued = (mapper.n_rescued, mapper.n_rescued_mapped)
    writer = PAFWriter(args.output, idx.ref_names, idx.ref_lengths)
    for rec in records:
        writer.append(rec)
    n = writer.finalize()
    LAST_MAP.clear()
    LAST_MAP.update(reads=len(signals), records=n, map_s=t_map,
                    rescued=rescued[0], rescued_mapped=rescued[1])
    print(
        f"Finished mapping in {time.time() - t0:.1f}s "
        f"(mapping {t_map:.3f}s), # reads: {len(signals)}, "
        f"# records: {n}, rescued: {rescued[0]}",
        file=sys.stderr,
    )
    return 0


def run_debug_mode(args) -> int:
    import torch

    from . import debug_modes

    if args.debug_mode == "fast5-to-text":
        path = debug_modes.fast5_to_text(args.sig_dir, args.output)
    elif args.debug_mode == "events-to-text":
        path = debug_modes.events_to_text(
            args.sig_dir, args.output, make_config(args)
        )
    else:
        if not torch.cuda.is_available():
            return _no_gpu(f"--debug-mode {args.debug_mode}")
        align = (debug_modes.dtw_align if args.debug_mode == "dtw-align"
                 else debug_modes.cwt_align)
        align(args.ref, args.pore_model, args.sig_dir, out=sys.stderr,
              device="cuda")
        path = "(stderr)"
    print(f"debug mode {args.debug_mode} -> {path}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.debug_mode:
        return run_debug_mode(args)
    if args.build_index:
        _build.native()
        return run_index(args)
    if args.map:
        _build.native()
        return run_map(args)
    build_parser().print_help(sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
