"""Native host code of the port (built with g++ at first use)."""
