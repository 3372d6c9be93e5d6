"""Measurement scripts run on the card; no solver imports them."""
