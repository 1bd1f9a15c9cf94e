"""Diffusion solver schedules."""
