"""Process grid and grid collectives."""
