"""Data paths: audio, token corpora, MIDI files and the MIDI scraper."""
