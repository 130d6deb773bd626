"""epilogue_share (layer: round): the share of the window in the batches'
round epilogues, each from its batch's last host signal until its last
record is made: the state's download, the records and the rescue
submissions (the program's ``round.epilogue`` spans).  A part of
``round_loop_share``."""

from benchmark import spans


def read(run):
    return spans.share(run, "round.epilogue")
