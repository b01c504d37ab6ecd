"""Checks of the port's run-time discipline.

``steady``: the steady-state guard, the eager counterpart of the JAX
package's ``analysis.retrace.no_retrace`` (the rest of ``repro.analysis``
is ROADMAP Queue 1 item 12).
"""
