"""Shared DNS rendering for the dnsmasq/bind/coredns runtimes."""
