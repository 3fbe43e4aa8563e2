"""The benchmark's harness: reads the cell's data files, makes the inputs
from the seed, drives picaso_tpu_torch through a measured window, traces
it, and holds what the window produced against the plain reference."""
