"""fast5 (HDF5) signal reading via h5py.

Replaces SignalBatch::AddSignalsFromFAST5/AddSignal (signal_batch.cc:68-154),
which use the vendored hdf5_tools.hpp.  Both layouts are supported:

* single-read fast5: /Raw/Reads/<Read_N>/Signal with read_id attr on the
  read group and calibration attrs on /UniqueGlobalKey/channel_id
  (detected by a "Raw" group at the root, signal_batch.cc:73-79);
* multi-read fast5: /<read_xxx>/Raw/Signal with calibration on
  /<read_xxx>/channel_id.
"""

from __future__ import annotations

import numpy as np

from .signals import ReadSignal, dac_to_pa


def _attr_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode()
    return str(v)


def read_fast5(path: str, pa_lo: float = 30.0, pa_hi: float = 200.0) -> list[ReadSignal]:
    import h5py

    out: list[ReadSignal] = []
    with h5py.File(path, "r") as f:
        is_single = "Raw" in f
        if is_single:
            for read_name in f["/Raw/Reads"]:
                grp = f["/Raw/Reads/" + read_name]
                read_id = _attr_str(grp.attrs.get("read_id", read_name))
                ch = f["/UniqueGlobalKey/channel_id"].attrs
                out.append(
                    _make_signal(
                        read_id, grp["Signal"][()], ch, pa_lo, pa_hi
                    )
                )
        else:
            for read_name in f:
                grp = f[read_name]
                raw = grp["Raw"]
                read_id = _attr_str(raw.attrs.get("read_id", read_name))
                ch = grp["channel_id"].attrs
                out.append(
                    _make_signal(read_id, raw["Signal"][()], ch, pa_lo, pa_hi)
                )
    return out


def _make_signal(read_id, raw, ch_attrs, pa_lo, pa_hi) -> ReadSignal:
    digitisation = float(ch_attrs["digitisation"])
    rng = float(ch_attrs["range"])
    offset = float(ch_attrs["offset"])
    pa = dac_to_pa(np.asarray(raw), digitisation, rng, offset, pa_lo, pa_hi)
    return ReadSignal(read_id, digitisation, rng, offset, pa)


def write_multi_fast5(path: str, reads: list[dict]) -> None:
    """Write a multi-read fast5 (for tests/benchmarks).

    Each read dict: read_id, raw (int16 array), digitisation, range, offset.
    """
    import h5py

    with h5py.File(path, "w") as f:
        for r in reads:
            g = f.create_group("read_" + r["read_id"])
            raw = g.create_group("Raw")
            raw.attrs["read_id"] = np.bytes_(r["read_id"])
            raw.create_dataset(
                "Signal", data=np.asarray(r["raw"], dtype=np.int16)
            )
            ch = g.create_group("channel_id")
            ch.attrs["digitisation"] = float(r["digitisation"])
            ch.attrs["range"] = float(r["range"])
            ch.attrs["offset"] = float(r["offset"])
            ch.attrs["sampling_rate"] = float(r.get("sampling_rate", 4000.0))
