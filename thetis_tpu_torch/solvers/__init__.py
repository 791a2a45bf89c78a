"""FGMRES core and the assembled 1-ring Krylov solve."""
