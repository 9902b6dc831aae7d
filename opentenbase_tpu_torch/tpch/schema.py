"""TPC-H schema DDL in this engine's dialect (XC-style DISTRIBUTE BY —
reference grammar extension; co-location choices follow common OpenTenBase
TPC-H deployment: big tables sharded on their join keys, dimensions
replicated)."""

SCHEMA = """
create table region (
    r_regionkey integer primary key,
    r_name varchar(25),
    r_comment varchar(152)
) distribute by replication;

create table nation (
    n_nationkey integer primary key,
    n_name varchar(25),
    n_regionkey integer,
    n_comment varchar(152)
) distribute by replication;

create table supplier (
    s_suppkey bigint primary key,
    s_name varchar(25),
    s_address varchar(40),
    s_nationkey integer,
    s_phone varchar(15),
    s_acctbal decimal(15,2),
    s_comment varchar(101)
) distribute by shard(s_suppkey);

create table customer (
    c_custkey bigint primary key,
    c_name varchar(25),
    c_address varchar(40),
    c_nationkey integer,
    c_phone varchar(15),
    c_acctbal decimal(15,2),
    c_mktsegment varchar(10),
    c_comment varchar(117)
) distribute by shard(c_custkey);

create table part (
    p_partkey bigint primary key,
    p_name varchar(55),
    p_mfgr varchar(25),
    p_brand varchar(10),
    p_type varchar(25),
    p_size integer,
    p_container varchar(10),
    p_retailprice decimal(15,2),
    p_comment varchar(23)
) distribute by shard(p_partkey);

create table partsupp (
    ps_partkey bigint,
    ps_suppkey bigint,
    ps_availqty integer,
    ps_supplycost decimal(15,2),
    ps_comment varchar(199),
    primary key (ps_partkey, ps_suppkey)
) distribute by shard(ps_partkey);

create table orders (
    o_orderkey bigint primary key,
    o_custkey bigint,
    o_orderstatus varchar(1),
    o_totalprice decimal(15,2),
    o_orderdate date,
    o_orderpriority varchar(15),
    o_clerk varchar(15),
    o_shippriority integer,
    o_comment varchar(79)
) distribute by shard(o_orderkey);

create table lineitem (
    l_orderkey bigint,
    l_partkey bigint,
    l_suppkey bigint,
    l_linenumber integer,
    l_quantity decimal(15,2),
    l_extendedprice decimal(15,2),
    l_discount decimal(15,2),
    l_tax decimal(15,2),
    l_returnflag varchar(1),
    l_linestatus varchar(1),
    l_shipdate date,
    l_commitdate date,
    l_receiptdate date,
    l_shipinstruct varchar(25),
    l_shipmode varchar(10),
    l_comment varchar(44),
    primary key (l_orderkey, l_linenumber)
) distribute by shard(l_orderkey);
"""
