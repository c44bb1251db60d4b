"""Experiments: config -> datamodule + model + trainer -> fit/test."""
