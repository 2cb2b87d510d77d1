"""Entries: how a traffic mix drives the program. Each module here that
defines ``Entry`` is an entry a traffic file can name."""
