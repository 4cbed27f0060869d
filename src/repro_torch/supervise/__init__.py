"""Fault injection (`inject`); the supervisor is not ported yet."""
