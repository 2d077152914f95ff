"""The FedALIGN round engine and the federation driver."""
