"""Tools that run on the card beside chip_smoke.py (see each module)."""
