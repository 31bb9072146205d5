"""Complex-as-real IAR scan and eigenpair refinement."""
