"""Radiative-convective equilibrium climate solve (port of
``picaso_tpu/climate``): chemical equilibrium, dry adiabat."""
