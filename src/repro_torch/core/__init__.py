"""Federated round engine, Sophia update, GNB estimator, lr schedules."""
