"""Reasoning heads of the port."""
