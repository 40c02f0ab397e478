"""Core of the port: graphs, the Pregel engine, the registry, the planner
and the service tier.  Submodules are imported directly (``from
repro_torch.core import graph``); nothing is imported eagerly here."""
