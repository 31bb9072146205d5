"""Compute protocol and NEP base class."""
