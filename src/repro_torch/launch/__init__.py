"""Launchers of the port: the party group and the federated LM trainer."""
