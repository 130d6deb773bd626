"""head_stage_share (layer: batch head): the share of the window in
``stage_batch``, each read's pA copied into the batch's pinned host buffer
(the program's ``head.stage`` spans; on the prepare thread where the
batches overlap)."""

from benchmark import spans


def read(run):
    return spans.share(run, "head.stage")
