"""Params, logging and the UI/log string table."""
