"""CNN graph builders, the graph executor and the family registry."""
