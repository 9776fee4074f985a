"""Kinetic-energy power spectra (port of
``climatemachine_tpu/common/spectra.py``, numpy on the host: the
diagnostics copy their interpolated fields to the host once per write).

``power_spectrum_3d`` (LES: the shell-binned 3-D FFT),
``power_spectrum_1d`` (GCM: the zonal FFT per latitude ring) and the
spherical-harmonic ``power_spectrum_2d`` on a Gauss-Legendre grid
(``gaussian_latitudes``, ``legendre_table``, ``spherical_transform``,
``gaussian_lats_deg``).  The shell binning is a bincount over integer
radii."""

from __future__ import annotations

import numpy as np


def power_spectrum_3d(u, v, w, L):
    """Shell-averaged KE spectrum of equispaced 3-D fields [N, N, N].

    Returns (k, spectrum): wavenumbers (rad/m) and binned KE density."""
    u, v, w = (np.asarray(x) for x in (u, v, w))
    N = u.shape[0]
    mu = np.abs(np.fft.fftn(u)) / N ** 3
    mv = np.abs(np.fft.fftn(v)) / N ** 3
    mw = np.abs(np.fft.fftn(w)) / N ** 3
    E = mu ** 2 + mv ** 2 + mw ** 2

    freq = np.fft.fftfreq(N, d=1.0 / N)          # integer wavenumbers
    KX, KY, KZ = np.meshgrid(freq, freq, freq, indexing="ij")
    r = np.sqrt(KX ** 2 + KY ** 2 + KZ ** 2)
    k_nyq = N // 2
    shell = np.clip(np.round(r).astype(int), 0, k_nyq)
    spectrum = np.bincount(shell.reshape(-1), weights=E.reshape(-1),
                           minlength=k_nyq + 1)[1:k_nyq + 1]
    dk = 2 * np.pi / L
    k = np.arange(1, k_nyq + 1) * dk
    return k, spectrum


def power_spectrum_1d(u, lat_weights=None):
    """Zonal (per-latitude-ring) spectrum of u [nlat, nlon(, nlev)]
    (reference power_spectrum_gcm.jl): returns [nlat, nlon//2(, nlev)]
    power per zonal wavenumber, optionally latitude-averaged."""
    u = np.asarray(u)
    nlon = u.shape[1]
    uf = np.fft.fft(u, axis=1) / nlon
    p = np.abs(uf) ** 2
    half = p[:, 1:nlon // 2 + 1] * 2.0
    if lat_weights is not None:
        wsum = np.sum(lat_weights)
        half = np.tensordot(lat_weights / wsum, half, axes=(0, 0))
    return half


# --- spherical-harmonic (2-D) spectra --------------------------------------
# Scope of reference power_spectrum_gcm.jl:78 power_spectrum_2d +
# spherical_helper.jl (SpectralSphericalMesh, compute_legendre!,
# compute_gaussian!, trans_grid_to_spherical!).  The associated-Legendre
# table and quadrature weights are set up once; the transform is one
# rfft and one einsum.


def gaussian_latitudes(nlat):
    """Gauss-Legendre nodes/weights in sin(latitude) (reference
    compute_gaussian!): returns (sinlat [nlat] ascending, w [nlat])."""
    x, w = np.polynomial.legendre.leggauss(nlat)
    return x, w


def legendre_table(num_fourier, num_spherical, sinlat):
    """Normalized associated Legendre P[m, n, lat] for m ≤ num_fourier,
    n ≤ num_spherical (reference compute_legendre!).

    Normalization: ∫_{-1}^{1} P_n^m(x)² dx = 1, so Gauss-Legendre
    quadrature of P·P over the table is the identity (validated in
    tests).  Entries with n < m are zero."""
    x = np.asarray(sinlat, dtype=np.float64)
    cos = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    M, N = num_fourier + 1, num_spherical + 1
    P = np.zeros((M, N, x.size))
    P[0, 0] = np.sqrt(0.5)
    for m in range(1, M):
        P[m, m] = np.sqrt((2 * m + 1) / (2.0 * m)) * cos * P[m - 1, m - 1]
    for m in range(M):
        if m + 1 < N:
            P[m, m + 1] = np.sqrt(2 * m + 3.0) * x * P[m, m]
        for n in range(m + 2, N):
            a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = np.sqrt(((n - 1.0) ** 2 - m * m) / (4.0 * (n - 1.0) ** 2 - 1.0))
            P[m, n] = a * (x * P[m, n - 1] - b * P[m, n - 2])
    return P


def spherical_transform(var, P, w):
    """Spherical-harmonic analysis of var [nlon, nlat, ...] on a gaussian
    grid (reference trans_grid_to_spherical!): returns complex
    coefficients [m, n, ...] with a_mn = Σ_lat w·P_n^m · (rfft_lon var)/nlon."""
    var = np.asarray(var)
    nlon = var.shape[0]
    M = P.shape[0]
    am = np.fft.rfft(var, axis=0)[:M] / nlon     # [m, lat, ...]
    return np.einsum("mnj,mj...->mn...", P * w[None, None, :], am)


def power_spectrum_2d(var, P, w):
    """Spherical power spectrum of var [nlon, nlat(, nz)] (reference
    power_spectrum_gcm.jl:78): returns spectrum [m, n(, nz)] with the
    factor 2 for m > 0 (negative zonal frequencies)."""
    coeff = spherical_transform(var, P, w)
    spec = np.abs(coeff) ** 2
    spec[1:] *= 2.0
    return spec


def gaussian_lats_deg(nlat):
    """Gauss-Legendre latitudes in degrees (ascending) — pass as the
    interpolation latitudes to enable spherical-harmonic spectra."""
    sinlat, _ = gaussian_latitudes(nlat)
    return np.rad2deg(np.arcsin(sinlat))
