"""Trainers of the port: fast PPO over the packed engine, pixel PPO, the
parity-grade PPO of the flax families, recurrent PPO, and the imitation
trainers (snapshot BC with DAgger, flat BC)."""
