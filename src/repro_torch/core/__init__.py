"""DAS core of the port: suffix-tree drafting, budgets, length policy,
lossless verification, fused device rounds and the lock-step engine.

Submodules are imported explicitly (``from repro_torch.core.spec_engine
import SpecEngine``) so importing a host-only module never pulls in the
model stack.
"""
