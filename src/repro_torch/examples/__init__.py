"""The port's counterparts of the reference's examples
(``examples/moe_expert_paging.py``, ``examples/serve_batched.py``); each
runs with ``python -m repro_torch.examples.<name>``, on the card unless
asked for the CPU."""
