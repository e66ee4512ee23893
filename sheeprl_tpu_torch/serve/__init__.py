"""Stateful session serving: policy contract, session cache and engine,
micro-batching scheduler, weight store, server and socket front end."""
