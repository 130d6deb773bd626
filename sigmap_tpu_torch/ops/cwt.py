"""Continuous wavelet transform feature pipeline (debug/alternative path).

Replaces the reference's vendored wavelib port (cwt.cc, 1871 LoC of FFT +
CWT kernels) with an FFT formulation (numpy fp32 host path; jnp available
for device use).  Conventions transcribed from the reference:

* zero-mean signal zero-padded to npad = 2^(1 + int(0.499999 + log2(N)))
  (cwt.cc:1700-1702);
* frequency-domain multiply with the DOG (derivative-of-Gaussian) daughter
  wavelet: norm * (scale*k)^m * exp(-(scale*k)^2/2), m even, sign rule
  from cwt.cc:1604-1611, norm = sign*sqrt(2*pi*scale/dt)/sqrt(gamma(m+.5));
* output = real part of the first scale row (GenerateCWTSignal,
  sigmap.cc:1157-1174; scales = s0 * pow^(i*dj), setCWTScales cwt.cc:1711);
* the feature pipeline (GenerateFeatureSignalUsingCWT, sigmap.cc:1085-1098)
  is MAD-normalize -> CWT(scale0) -> z-score -> peak/valley extraction with
  selectivity = SD/4 (the z-score helper *returns the SD*, which the
  reference assigns to a variable named `mean` - quirk preserved).
"""

from __future__ import annotations

import math

import numpy as np


def npad_for(n: int) -> int:
    ibase2 = 1 + int(0.499999 + math.log2(n))
    return 1 << ibase2


def dog_daughter(npad: int, scale: float, dt: float = 1.0,
                 m: int = 2) -> np.ndarray:
    """DOG wavelet in frequency domain over the full wavenumber array
    (cwt.cc:1597-1633, even-m branch)."""
    freq1 = 2.0 * np.pi / (npad * dt)
    k = np.zeros(npad)
    k[1 : npad // 2 + 1] = np.arange(1, npad // 2 + 1) * freq1
    k[npad // 2 + 1 :] = -k[1 : (npad + 1) // 2][::-1]
    sign = -1.0 if m % 4 in (0, 1) else 1.0
    norm = sign * math.sqrt(2.0 * np.pi * scale / dt) / math.sqrt(
        math.gamma(m + 0.5)
    )
    t = scale * k
    if m % 2 == 0:
        return (norm * t**m * np.exp(-0.5 * t * t)).astype(np.complex64)
    return (1j * norm * t**m * np.exp(-0.5 * t * t)).astype(np.complex64)


def cwt_dog(signal: np.ndarray, scale: float, dt: float = 1.0,
            m: int = 2) -> np.ndarray:
    """Single-scale DOG CWT, real part (cwt.cc cwavelet + sigmap.cc:1169)."""
    x = np.asarray(signal, np.float32)
    n = len(x)
    npad = npad_for(n)
    ypad = np.zeros(npad, np.float32)
    ypad[:n] = x - x.mean(dtype=np.float64).astype(np.float32)
    daughter = dog_daughter(npad, scale, dt, m)
    out = np.fft.ifft(np.fft.fft(ypad) * daughter)
    return out.real[:n].astype(np.float32)


def mad_normalize(signal: np.ndarray) -> np.ndarray:
    """GenerateMADNormalizedSignal (sigmap.cc:1100-1129): the reference's
    'fake median' = element n//2 of an nth_element partition."""
    x = np.asarray(signal, np.float32)
    n = len(x)
    med = np.partition(x, n // 2)[n // 2]
    mad = np.partition(np.abs(x - med), n // 2)[n // 2]
    return ((x - med) / mad).astype(np.float32)


def zscore_with_sd(x: np.ndarray) -> tuple[np.ndarray, float]:
    """z-score returning the SD (GenerateZscoreNormalizedSignal returns SD,
    sigmap.cc:1131-1155)."""
    x64 = np.asarray(x, np.float64)
    mean = x64.mean()
    sd = math.sqrt(((x64 - mean) ** 2).sum() / (len(x64) - 1))
    return ((x64 - mean) / sd).astype(np.float32), sd


def generate_peaks(signal: np.ndarray, selective: float):
    """Alternating peak/valley extraction (sigmap.cc:1176-1196)."""
    x = np.asarray(signal, np.float32)
    peaks, positions = [], []
    prev_valley = float(x[0])
    prev_peak = float(x[0])
    for i in range(1, len(x) - 1):
        v = float(x[i])
        if v > x[i - 1] and v >= x[i + 1] and v >= prev_valley + selective:
            peaks.append(v)
            positions.append(i)
            prev_peak = v
        elif v < x[i - 1] and v <= x[i + 1] and v <= prev_peak - selective:
            peaks.append(v)
            positions.append(i)
            prev_valley = v
    return np.array(peaks, np.float32), np.array(positions, np.int64)


def cwt_feature_signal(signal: np.ndarray, scale0: float):
    """GenerateFeatureSignalUsingCWT (sigmap.cc:1085-1098):
    returns (features, feature_positions)."""
    mad = mad_normalize(signal)
    c = cwt_dog(mad, scale0)
    z, sd = zscore_with_sd(c)
    return generate_peaks(z, sd / 4.0)
