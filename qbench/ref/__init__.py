"""Plain references: straightforward shortest paths in plain torch.

They build their own adjacency from the arcs the generators made, import
nothing of the port, and take nothing the port made.
"""
