"""Radiative transfer: Toon89 solvers, the spectrum kernel, transit."""
