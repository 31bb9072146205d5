"""Host-side banded encodings (the sharded solvers are not ported yet)."""
