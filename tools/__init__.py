"""Scripts that run the port on a CUDA card beside ``chip_smoke.py``."""
