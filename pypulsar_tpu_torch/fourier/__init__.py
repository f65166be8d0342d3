"""Fourier-domain acceleration search of dedispersed series."""
