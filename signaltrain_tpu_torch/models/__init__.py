"""The knob-conditioned magnitude/phase autoencoder and its geometry."""
