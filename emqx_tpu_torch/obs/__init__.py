"""Observability seams the port's match path reports into."""
