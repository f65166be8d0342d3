"""Folding of candidates into pulse profiles, and their SNR."""
