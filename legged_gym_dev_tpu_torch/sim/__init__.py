"""Batched rigid-body simulator: URDF model, scalar-graph dynamics,
compliant contact and the substep (kernel on the card)."""
