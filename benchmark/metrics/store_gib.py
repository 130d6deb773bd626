"""store_gib (layer: index): the device memory of the program's sweep
tile store in GiB, the counter ``store_bytes`` that the window's last
call carries (tiles, packed meta, cell table and the rotation's small
arrays; see ``sigmap_tpu_torch/mapping/spans.py``), the resident part of
``device_peak_gib``.  Nothing where the program counts no such bytes."""

GIB = 1 << 30


def read(run):
    for c in reversed(run.calls):
        n = c.stamps.get("store_bytes")
        if n is not None:
            return n / GIB
    return None
