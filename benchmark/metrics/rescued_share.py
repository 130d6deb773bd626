"""rescued_share (layer: rescue): reads re-mapped by the exact engine over
reads attempted in the window (the change of ``TurboMapper.n_rescued``), a
count."""


def read(run):
    if not run.attempted:
        return None
    return run.rescued / run.attempted
