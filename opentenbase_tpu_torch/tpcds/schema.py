"""TPC-DS schema (trimmed to the columns the query set touches).
Distribution follows TPC-DS practice on XC-style clusters: fact tables
sharded on their sales surrogate keys, dimensions replicated
(reference: the same layout OpenTenBase docs recommend for star
schemas — small dims LOCATOR_TYPE_REPLICATED, facts SHARD)."""

SCHEMA = """
create table date_dim (
    d_date_sk bigint primary key,
    d_date date,
    d_year int,
    d_moy int,
    d_dow int,
    d_month_seq int
) distribute by replication;

create table item (
    i_item_sk bigint primary key,
    i_brand_id int,
    i_brand varchar(20),
    i_category_id int,
    i_category varchar(20),
    i_class varchar(20),
    i_manufact_id int,
    i_manager_id int,
    i_current_price decimal(7,2)
) distribute by replication;

create table store (
    s_store_sk bigint primary key,
    s_store_name varchar(20),
    s_state varchar(2),
    s_county varchar(20)
) distribute by replication;

create table customer (
    c_customer_sk bigint primary key,
    c_first_name varchar(16),
    c_last_name varchar(16),
    c_birth_year int,
    c_current_addr_sk bigint,
    c_current_cdemo_sk bigint,
    c_current_hdemo_sk bigint
) distribute by replication;

create table customer_address (
    ca_address_sk bigint primary key,
    ca_state varchar(2),
    ca_city varchar(20),
    ca_county varchar(20),
    ca_gmt_offset int
) distribute by replication;

create table customer_demographics (
    cd_demo_sk bigint primary key,
    cd_gender varchar(1),
    cd_marital_status varchar(1),
    cd_education_status varchar(20),
    cd_dep_count int
) distribute by replication;

create table household_demographics (
    hd_demo_sk bigint primary key,
    hd_buy_potential varchar(10),
    hd_dep_count int,
    hd_vehicle_count int
) distribute by replication;

create table warehouse (
    w_warehouse_sk bigint primary key,
    w_warehouse_name varchar(20),
    w_state varchar(2)
) distribute by replication;

create table promotion (
    p_promo_sk bigint primary key,
    p_channel_email varchar(1),
    p_channel_event varchar(1)
) distribute by replication;

create table store_sales (
    ss_ticket int,
    ss_sold_date_sk bigint,
    ss_item_sk bigint,
    ss_customer_sk bigint,
    ss_cdemo_sk bigint,
    ss_hdemo_sk bigint,
    ss_addr_sk bigint,
    ss_store_sk bigint,
    ss_promo_sk bigint,
    ss_quantity int,
    ss_list_price decimal(10,2),
    ss_sales_price decimal(10,2),
    ss_coupon_amt decimal(10,2),
    ss_ext_sales_price decimal(10,2),
    ss_net_profit decimal(10,2)
) distribute by shard(ss_ticket);

create table store_returns (
    sr_ticket int,
    sr_item_sk bigint,
    sr_returned_date_sk bigint,
    sr_customer_sk bigint,
    sr_store_sk bigint,
    sr_reason_sk bigint,
    sr_return_quantity int,
    sr_return_amt decimal(10,2)
) distribute by shard(sr_ticket);

create table catalog_sales (
    cs_order int,
    cs_sold_date_sk bigint,
    cs_ship_date_sk bigint,
    cs_item_sk bigint,
    cs_bill_customer_sk bigint,
    cs_bill_cdemo_sk bigint,
    cs_warehouse_sk bigint,
    cs_promo_sk bigint,
    cs_ship_mode_sk bigint,
    cs_call_center_sk bigint,
    cs_quantity int,
    cs_sales_price decimal(10,2),
    cs_ext_sales_price decimal(10,2),
    cs_net_profit decimal(10,2)
) distribute by shard(cs_order);

create table catalog_returns (
    cr_order int,
    cr_item_sk bigint,
    cr_returned_date_sk bigint,
    cr_returning_customer_sk bigint,
    cr_call_center_sk bigint,
    cr_return_quantity int,
    cr_return_amount decimal(10,2)
) distribute by shard(cr_order);

create table web_sales (
    ws_order int,
    ws_sold_date_sk bigint,
    ws_ship_date_sk bigint,
    ws_item_sk bigint,
    ws_bill_customer_sk bigint,
    ws_promo_sk bigint,
    ws_ship_mode_sk bigint,
    ws_warehouse_sk bigint,
    ws_web_site_sk bigint,
    ws_quantity int,
    ws_sales_price decimal(10,2),
    ws_ext_sales_price decimal(10,2),
    ws_net_profit decimal(10,2)
) distribute by shard(ws_order);

create table web_returns (
    wr_order int,
    wr_item_sk bigint,
    wr_returned_date_sk bigint,
    wr_returning_customer_sk bigint,
    wr_return_quantity int,
    wr_return_amt decimal(10,2),
    wr_net_loss decimal(10,2)
) distribute by shard(wr_order);

create table ship_mode (
    sm_ship_mode_sk bigint primary key,
    sm_type varchar(12)
) distribute by replication;

create table reason (
    r_reason_sk bigint primary key,
    r_reason_desc varchar(20)
) distribute by replication;

create table call_center (
    cc_call_center_sk bigint primary key,
    cc_name varchar(12),
    cc_county varchar(20)
) distribute by replication;

create table web_site (
    web_site_sk bigint primary key,
    web_name varchar(12)
) distribute by replication;

create table inventory (
    inv_item_sk bigint,
    inv_warehouse_sk bigint,
    inv_date_sk bigint,
    inv_quantity_on_hand int
) distribute by shard(inv_item_sk);
"""
