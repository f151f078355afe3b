"""HMC trajectory."""
