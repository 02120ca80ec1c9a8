"""Kernel-backed ops of the port and their plain versions."""
