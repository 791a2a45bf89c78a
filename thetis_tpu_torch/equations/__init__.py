"""Equation infrastructure, the 2D shallow water equations and their analytic ring-block assembly."""
