from .build import SignalIndex, build_index
