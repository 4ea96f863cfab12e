"""Self-driving model lifecycle of the port: the unattended
train → validate → canary → promote controller (``controller``)."""

from .controller import FleetController, GATE_CHAIN

__all__ = ["FleetController", "GATE_CHAIN"]
