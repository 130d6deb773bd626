"""setup_build_s (layer: index): the seconds of the program's set-up
builds, summed: the ``build`` spans that the window's last call carries
(``setup.index``, the index; ``setup.tree``, the rescue's k-d tree;
``setup.tile_store``, the sweep tile store; see
``sigmap_tpu_torch/mapping/spans.py``).  Nothing where the program
records no such spans."""


def read(run):
    for c in reversed(run.calls):
        found = c.stamps.get("build")
        if found:
            return sum(s.t1 - s.t0 for s in found)
    return None
