"""Offline analysis tools (the port of `f8net_tpu/tools/`): the sigma ->
fraclen Monte-Carlo study, the fraclen profile, the BN-folded weight
distributions."""
