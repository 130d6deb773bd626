"""head_quantize_share (layer: batch head): the share of the window in a
batch's upload and ``quantize``, its read-back of fits, minima and maxima
included (the program's ``head.quantize`` spans; on the prepare thread
where the batches overlap)."""

from benchmark import spans


def read(run):
    return spans.share(run, "head.quantize")
