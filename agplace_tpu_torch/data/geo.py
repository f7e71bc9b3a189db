"""WGS84 lat/lon -> UTM east/north (``agplace_tpu/data/geo.py``), float64
numpy, vectorised.

The standard Krüger series, the ``utm`` package's formulation: accurate to
centimetres, far below the 10 m / 25 m ground-truth radii.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

# WGS84
_R = 6378137.0
_E = 0.00669438  # first eccentricity squared
_E2 = _E * _E
_E3 = _E2 * _E
_E_P2 = _E / (1.0 - _E)
_K0 = 0.9996

_M1 = 1 - _E / 4 - 3 * _E2 / 64 - 5 * _E3 / 256
_M2 = 3 * _E / 8 + 3 * _E2 / 32 + 45 * _E3 / 1024
_M3 = 15 * _E2 / 256 + 45 * _E3 / 1024
_M4 = 35 * _E3 / 3072

_ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"


def latlon_to_zone_number(lat, lon):
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    zone = (np.floor((lon + 180) / 6) + 1).astype(np.int64)
    # Norway exception
    norway = (np.asarray(lat >= 56) & (lat < 64) & (lon >= 3) & (lon < 12))
    zone = np.where(norway, 32, zone)
    # Svalbard exceptions
    sval = (lat >= 72) & (lat <= 84)
    zone = np.where(sval & (lon >= 0) & (lon < 9), 31, zone)
    zone = np.where(sval & (lon >= 9) & (lon < 21), 33, zone)
    zone = np.where(sval & (lon >= 21) & (lon < 33), 35, zone)
    zone = np.where(sval & (lon >= 33) & (lon < 42), 37, zone)
    return zone


def latitude_to_zone_letter(lat):
    lat = np.asarray(lat)
    idx = np.clip(((lat + 80) / 8).astype(np.int64), 0, 20)
    if np.isscalar(lat) or lat.ndim == 0:
        return _ZONE_LETTERS[int(idx)]
    return np.array([_ZONE_LETTERS[i] for i in np.atleast_1d(idx)])


def from_latlon(lat, lon, force_zone_number=None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Union[str, np.ndarray]]:
    """utm.from_latlon-compatible: returns (easting, northing, zone_number,
    zone_letter)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    lat_rad = np.radians(lat)
    lat_sin = np.sin(lat_rad)
    lat_cos = np.cos(lat_rad)
    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2

    zone = (np.asarray(force_zone_number) if force_zone_number is not None
            else latlon_to_zone_number(lat, lon))
    central_lon = (zone - 1) * 6 - 180 + 3
    lon_rad = np.radians(lon)
    central_rad = np.radians(central_lon.astype(np.float64))

    n = _R / np.sqrt(1 - _E * lat_sin ** 2)
    c = _E_P2 * lat_cos ** 2
    a = lat_cos * (np.mod(lon_rad - central_rad + np.pi, 2 * np.pi) - np.pi)
    a2, a3, a4, a5, a6 = a * a, a ** 3, a ** 4, a ** 5, a ** 6

    m = _R * (_M1 * lat_rad
              - _M2 * np.sin(2 * lat_rad)
              + _M3 * np.sin(4 * lat_rad)
              - _M4 * np.sin(6 * lat_rad))

    easting = _K0 * n * (
        a + a3 / 6 * (1 - lat_tan2 + c)
        + a5 / 120 * (5 - 18 * lat_tan2 + lat_tan4 + 72 * c - 58 * _E_P2)
    ) + 500000.0
    northing = _K0 * (
        m + n * lat_tan * (
            a2 / 2
            + a4 / 24 * (5 - lat_tan2 + 9 * c + 4 * c * c)
            + a6 / 720 * (61 - 58 * lat_tan2 + lat_tan4 + 600 * c
                          - 330 * _E_P2)
        )
    )
    northing = np.where(lat < 0, northing + 10000000.0, northing)
    return easting, northing, zone, latitude_to_zone_letter(lat)
