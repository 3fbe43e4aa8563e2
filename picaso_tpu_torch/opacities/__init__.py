"""Opacity grids, optical-depth assembly and the gather kernel."""
