"""Numeric helpers shared by the plain kernel versions."""
