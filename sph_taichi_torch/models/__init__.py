"""WCSPH solver and the shared SPH machinery."""
