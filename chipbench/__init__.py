"""The port's benchmark: fine-tuning cells of ``repro_torch`` on the card.
``run.py`` runs one; ``control.py`` reads the comparison's limits."""
