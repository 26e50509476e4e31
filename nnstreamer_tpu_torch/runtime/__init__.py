"""Streaming runtime: channels, the host-sync choke point, the scheduler."""
