"""Model options, field registry and the 3D ``FlowSolver``."""
