"""Launchers of the port: `train`, the federated LM trainer."""
