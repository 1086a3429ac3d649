"""Input generators: graphs, query pairs and arrival times, all from the seed."""
