"""Dedispersion planning (DDplan) on the host."""
