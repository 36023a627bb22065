"""Eval-mode model towers of the port (nn.Modules)."""
