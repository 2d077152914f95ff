"""FedALIGN's core math: the eps-band gate, gated aggregation, history."""
