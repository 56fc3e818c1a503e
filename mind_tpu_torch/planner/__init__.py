"""The MIND plan cycle: scene prep, AIME, cost topology, tree iLQR, selection."""
