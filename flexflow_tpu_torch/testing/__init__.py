"""Test-harness subsystems that ship with the port (a copy of the JAX
package's ``testing/``).

``chaos`` is the deterministic fault injector (``FF_CHAOS``); the port
wires its ``serve`` site.  ``fleet`` replays seeded incident scenarios
against a live replica pool and autoscaler.
"""

from . import chaos  # noqa: F401
