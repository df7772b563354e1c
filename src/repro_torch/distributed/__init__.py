"""Planning across devices (port of ``repro/distributed``)."""
