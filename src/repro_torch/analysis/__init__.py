"""Runtime shadow-verify plane (see ``repro_torch.analysis.shadow``).

The simulator keeps two views of every request and instance — object
fields (``Request``, ``SimInstance``) and columnar mirrors
(``RequestLedger``, ``InstancePlane``, the queue's lane columns) — in sync
by hand at each mutation site. ``simulate_events(..., shadow_verify=True)``
(env ``CHIRON_SHADOW_VERIFY=1``) rebuilds those columns from the objects at
control ticks and completion sweeps and asserts exact agreement.

The repo's static auditor of the same mirrors and its determinism lints
(the reference's ``analysis.checks`` and ``analysis.findings``) are not
part of the port yet (ROADMAP.md, Queue A item 9c); the auditor reads the
``mirror-sync`` annotations and the ``*_MIRRORS`` registries in this
package all the same.
"""
from repro_torch.analysis.shadow import ShadowVerifier, ShadowVerifyError, resolve

__all__ = ["ShadowVerifier", "ShadowVerifyError", "resolve"]
