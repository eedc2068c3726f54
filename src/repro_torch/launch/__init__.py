"""Launchers of the port: `train`, the federated LM trainer; `serve`,
batched prefill and decode; and the cost tools (`api`, `op_cost`,
`roofline`, `dryrun`, `profile`), which trace every arch x input shape
shape-only on one card."""
