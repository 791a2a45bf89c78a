"""Equation infrastructure, the 2D shallow water equations and their
analytic ring-block assembly, and the 3D momentum, tracer, EOS, limiter
and column-diagnostic modules of the baroclinic step."""
