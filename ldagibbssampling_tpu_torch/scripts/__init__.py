"""Entry points beside the trainer: hardware probes of the card."""
