"""Telescope tables: a copy of ``pypulsar_tpu/astro/telescopes.py``.

Name <-> TEMPO observatory code and max-hour-angle lookups.
"""

telescope_to_id = {
    "GBT": "1",
    "Arecibo": "3",
    "VLA": "6",
    "Parkes": "7",
    "Jodrell": "8",
    "GB43m": "a",
    "GB 140FT": "a",
    "Nancay": "f",
    "Effelsberg": "g",
    "WSRT": "i",
    "GMRT": "r",
    "Geocenter": "0",
    "Barycenter": "@",
}

id_to_telescope = {
    "1": "GBT",
    "3": "Arecibo",
    "6": "VLA",
    "7": "Parkes",
    "8": "Jodrell",
    "a": "GB 140FT",
    "f": "Nancay",
    "g": "Effelsberg",
    "i": "WSRT",
    "r": "GMRT",
    "0": "Geocenter",
    "@": "Barycenter",
}

telescope_to_maxha = {
    "GBT": 12,
    "Arecibo": 3,
    "VLA": 6,
    "Parkes": 12,
    "Jodrell": 12,
    "GB43m": 12,
    "GB 140FT": 12,
    "Nancay": 4,
    "Effelsberg": 12,
    "WSRT": 12,
    "GMRT": 12,
    "Geocenter": 12,
    "Barycenter": 12,
}
