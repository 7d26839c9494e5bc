"""Framework-free helpers."""
